"""Checkpoints in the reference's layout, read and written."""
