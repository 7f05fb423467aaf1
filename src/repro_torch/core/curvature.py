"""Tri-Accel §3.2 — Sparse Second-Order Signals.

Matrix-free per-layer curvature from Hessian-vector products:

  * ``power``      — the paper's method: top eigenvalue of each layer's
                     block-diagonal Hessian H_ll by power iteration. The
                     tangent is zero outside layer l, so the product gives
                     exactly H_ll v_l. Cost: layers x iters HVPs on b_curv.
  * ``hutchinson`` — beyond-paper: ALL per-layer trace estimates from a
                     single HVP per probe. For independent Rademacher blocks
                     E[z_l^T (Hz)_l] = tr(H_ll); cross-block terms vanish in
                     expectation. Reported as mean curvature tr/n_l.
  * ``fisher``     — free proxy: per-layer mean squared gradient (empirical
                     Fisher diagonal), no extra passes.

All return a per-layer curvature vector aligned with the model's layer
grouping. The HVP is a double backward: the gradient with its graph, then
the gradient of its dot with the tangent. H is symmetric, so that is the
reference's forward-over-reverse product. Probes come from an explicit CPU
``torch.Generator`` and move to the params' device, so a seed gives the
same probes on every device.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree as tu


def hvp(loss_fn: Callable, params, tangent, *args):
    """Hessian-vector product H(params) @ tangent, a tree like ``params``
    (detached). ``loss_fn(params, *args)`` is a scalar."""
    leaves, treedef = tu.flatten(params)
    xs = [l.detach().requires_grad_(True) for l in leaves]
    with torch.enable_grad():
        loss = loss_fn(tu.unflatten(treedef, xs), *args)
        gs = torch.autograd.grad(loss, xs, create_graph=True,
                                 allow_unused=True)
        terms = [(g * t.to(g.dtype)).sum()
                 for g, t in zip(gs, tu.leaves(tangent))
                 if g is not None and g.requires_grad]
        hv = (torch.autograd.grad(sum(terms), xs, allow_unused=True)
              if terms else [None] * len(xs))
    return tu.unflatten(treedef, [torch.zeros_like(x) if h is None
                                  else h.detach() for x, h in zip(xs, hv)])


def _tree_dot(a, b) -> torch.Tensor:
    return sum((x.float() * y.float()).sum()
               for x, y in zip(tu.leaves(a), tu.leaves(b)))


def _tree_norm(a) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(_tree_dot(a, a), 1e-30))


def _normalize(a):
    n = _tree_norm(a)
    return tu.tree_map(lambda x: (x.float() / n).to(x.dtype), a)


def _mask_to_layer(tree, select_fn):
    """Zero all leaves outside the selected layer (``select_fn`` acts on a
    leaf's path, a tuple of keys)."""
    leaves, treedef = tu.flatten(tree)
    return tu.unflatten(treedef, [
        leaf if select_fn(path) else torch.zeros_like(leaf)
        for path, leaf in zip(tu.paths(tree), leaves)])


def _rademacher_tree(tree, gen: torch.Generator):
    """Independent per-leaf Rademacher probes: one draw after another from
    ``gen``, so same-shape leaves get DISTINCT vectors."""
    def one(leaf):
        z = torch.randint(0, 2, tuple(leaf.shape), generator=gen,
                          dtype=torch.int8).float() * 2.0 - 1.0
        return z.to(device=leaf.device, dtype=leaf.dtype)
    return tu.tree_map(one, tree)


def power_iteration_layer(loss_fn: Callable, params, select_fn,
                          gen: torch.Generator, iters: int,
                          *args) -> torch.Tensor:
    """Top eigenvalue of the block H_ll selected by ``select_fn`` (path
    predicate)."""
    v = _normalize(_mask_to_layer(_rademacher_tree(params, gen), select_fn))
    lam = torch.zeros((), dtype=torch.float32,
                      device=tu.leaves(params)[0].device)
    for _ in range(iters):
        hv = _mask_to_layer(hvp(loss_fn, params, v, *args), select_fn)
        lam = _tree_dot(v, hv)
        v = _normalize(hv)
    return lam


def hutchinson_layer_traces(loss_fn: Callable, params, layer_reduce: Callable,
                            gen: torch.Generator, n_probes: int,
                            *args) -> torch.Tensor:
    """Per-layer tr(H_ll)/n_l estimates from ``n_probes`` full-tree HVPs.

    ``layer_reduce(tree_of_products) -> (L,)`` sums z*(Hz) within each layer
    group and divides by the group's parameter count (mean-eigenvalue proxy).
    """
    ests = []
    for _ in range(n_probes):
        z = _rademacher_tree(params, gen)
        hz = hvp(loss_fn, params, z, *args)
        ests.append(layer_reduce(tu.tree_map(
            lambda a, b: a.float() * b.float(), z, hz)))
    return sum(ests) / n_probes


def fisher_layer(grads, layer_reduce: Callable) -> torch.Tensor:
    """Empirical-Fisher proxy: per-layer mean of grad^2 (no extra passes)."""
    sq = tu.tree_map(lambda g: g.float() * g.float(), grads)
    return layer_reduce(sq)
