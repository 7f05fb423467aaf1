"""Ported models (ResNet-18 so far)."""
