"""Paper-experiment image models."""
