"""Optimizers (sgdm, adamw) whose update runs in the fused apply kernel."""
