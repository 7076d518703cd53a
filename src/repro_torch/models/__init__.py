"""Model definitions (the CNN family)."""
