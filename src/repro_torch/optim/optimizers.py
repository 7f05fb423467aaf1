"""Optimizers over f32 master params. On the slab-resident path the update
itself runs in the fused apply kernel (``kernels.fused_update``), which
specializes on ``Optimizer.spec``; ``init`` builds the moment trees that
``train_step.pack_state`` folds into slabs. The tree ``update`` of the
reference path is not ported yet."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree as tu
from repro_torch.kernels.fused_update import OptSpec


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    slots: int                   # f32 state slots per param (memory model)
    spec: OptSpec                # static hyperparameters for the kernel


def _zeros(params):
    return tu.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)


def sgdm(momentum: float = 0.9, weight_decay: float = 0.0,
         nesterov: bool = False) -> Optimizer:
    """SGD with momentum — the paper's baseline optimizer."""
    return Optimizer(lambda params: {"mu": _zeros(params)}, slots=1,
                     spec=OptSpec(kind="sgdm", momentum=momentum,
                                  nesterov=nesterov,
                                  weight_decay=weight_decay))


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        dev = tu.leaves(params)[0].device
        return {"m": _zeros(params), "v": _zeros(params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    return Optimizer(init, slots=2,
                     spec=OptSpec(kind="adamw", b1=b1, b2=b2, eps=eps,
                                  weight_decay=weight_decay))
