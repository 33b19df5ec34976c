"""Optimizer-side utilities; so far the weight-form half of compression."""
