"""The port's model stack: routed layers, attention, decoder stack, model facade."""
