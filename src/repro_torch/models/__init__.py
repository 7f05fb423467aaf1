"""Ported models: ResNet-18 (vision) and decoder-only LMs (smollm-135m)."""
