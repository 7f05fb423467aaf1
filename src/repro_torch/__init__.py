"""PyTorch/CUDA port of the Tri-Accel reproduction (``repro``).

Mirrors the reference package's subpackage paths: ``repro/x/y.py`` has its
counterpart at ``repro_torch/x/y.py``. Imports ``torch`` and ``numpy`` only
— never ``jax`` and nothing of ``repro``. Entry points (``Trainer``,
``run_method``, ``VisionTask``) run on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` without a card raises.
"""
import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    no card is present (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain CPU path")
    return dev
