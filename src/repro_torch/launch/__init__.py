"""Serving: the continuous-batching scheduler and the serve CLI."""
