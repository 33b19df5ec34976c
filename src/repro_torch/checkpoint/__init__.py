"""Checkpoints in the reference's layout (the read half)."""
