"""Tri-Accel §3.2 — per-layer curvature signals. Only the ``fisher`` proxy
(per-layer mean squared gradient, no extra passes) is ported so far; the
Hessian-vector-product methods need jvp-of-grad and wait."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree as tu


def fisher_layer(grads, layer_reduce: Callable) -> torch.Tensor:
    """Empirical-Fisher proxy: per-layer mean of grad^2."""
    sq = tu.tree_map(lambda g: g.float() * g.float(), grads)
    return layer_reduce(sq)
