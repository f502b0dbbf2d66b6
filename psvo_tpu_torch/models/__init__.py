"""State-space models and ground-truth dynamics."""
