"""Layers, attention, blocks and parameter initializers of the ported
models."""
