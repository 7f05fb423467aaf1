"""Optimizers over f32 master params with per-leaf LR scaling.

``update(grads, state, params, lr)`` is the reference path's tree update
(``train_step.reference_step``): ``lr`` is a scalar or a tree of per-leaf
multipliers (Tri-Accel's curvature-scaled per-layer learning rates,
broadcast to leaves by ``LayerGrouping.broadcast``). Each operation rounds
in f32 as the reference's source reads. On the slab-resident path the
update runs in the fused apply kernel instead (``kernels.fused_update``),
which specializes on ``Optimizer.spec``; ``init`` builds the moment trees
that ``train_step.pack_state`` folds into slabs.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tree as tu
from repro_torch.kernels.fused_update import OptSpec


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (grads, state, params, lr) -> (upd, state)
    slots: int                   # f32 state slots per param (memory model)
    #: static hyperparameters for the fused update kernel; None: the
    #: reference path (``train_step.reference_step``) only
    spec: Optional[OptSpec] = None


def _zeros(params):
    return tu.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)


def _lr_tree(lr, params):
    """Per-leaf multipliers: ``lr`` itself when it is a tree, else ``lr``
    repeated on every leaf."""
    if isinstance(lr, (int, float)) or (isinstance(lr, torch.Tensor)
                                        and lr.dim() == 0):
        return tu.tree_map(lambda p: lr, params)
    return lr


def sgdm(momentum: float = 0.9, weight_decay: float = 0.0,
         nesterov: bool = False) -> Optimizer:
    """SGD with momentum — the paper's baseline optimizer."""

    def init(params):
        return {"mu": _zeros(params)}

    def update(grads, state, params, lr):
        def upd(g, mu, p, s):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            mu = momentum * mu + g
            step = (momentum * mu + g) if nesterov else mu
            return (-s * step).to(p.dtype), mu

        ls, treedef = tu.flatten(params)
        out = [upd(g, mu, p, s) for g, mu, p, s in
               zip(tu.leaves(grads), tu.leaves(state["mu"]), ls,
                   tu.leaves(_lr_tree(lr, params)))]
        return (tu.unflatten(treedef, [o[0] for o in out]),
                {"mu": tu.unflatten(treedef, [o[1] for o in out])})

    return Optimizer(init, update, slots=1,
                     spec=OptSpec(kind="sgdm", momentum=momentum,
                                  nesterov=nesterov,
                                  weight_decay=weight_decay))


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        dev = tu.leaves(params)[0].device
        return {"m": _zeros(params), "v": _zeros(params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        c1 = 1.0 - b1 ** t.float()
        c2 = 1.0 - b2 ** t.float()

        def upd(g, m, v, p, s):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * (g * g)
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (-s * step).to(p.dtype), m, v

        ls, treedef = tu.flatten(params)
        out = [upd(g, m, v, p, s) for g, m, v, p, s in
               zip(tu.leaves(grads), tu.leaves(state["m"]),
                   tu.leaves(state["v"]), ls,
                   tu.leaves(_lr_tree(lr, params)))]
        pick = lambda i: tu.unflatten(treedef, [o[i] for o in out])  # noqa
        return pick(0), {"m": pick(1), "v": pick(2), "t": t}

    return Optimizer(init, update, slots=2,
                     spec=OptSpec(kind="adamw", b1=b1, b2=b2, eps=eps,
                                  weight_decay=weight_decay))


def apply_updates(params, updates):
    return tu.tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                       params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum((x.float() * x.float()).sum()
                          for x in tu.leaves(tree)))
