"""Parameter initializers for the ported models."""
