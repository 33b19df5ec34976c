"""Hardware table, program cache, execution stream and kernel routing."""
