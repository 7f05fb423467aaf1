"""Deterministic synthetic data streams."""
