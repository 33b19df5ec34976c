"""Training data: the seeded synthetic token pipeline."""
