"""Training loop building blocks."""
