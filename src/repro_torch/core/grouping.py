"""Per-layer parameter grouping — maps model param trees to the (L,) layer
vectors the Tri-Accel controller operates on: ``flat_grouping`` (vision,
by sorted top-level keys) and ``lm_grouping`` (LM stacks).

Layer order for LMs: all stack layers in network order, then one
pseudo-layer for the embedding group, then one for the head (final norm /
unembed)."""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from repro_torch import tree as tu


class LayerGrouping:
    """Maps a params-shaped tree to per-layer (L,) sums / means."""

    def __init__(self, num_layers: int, sums_fn: Callable,
                 counts: torch.Tensor, names: List[str],
                 broadcast_fn: Callable):
        self.num_layers = num_layers
        self._sums_fn = sums_fn
        self.counts = counts                  # (L,) f32 parameter counts
        self.names = names
        self._broadcast_fn = broadcast_fn

    def sums(self, tree, square: bool = False) -> torch.Tensor:
        return self._sums_fn(tree, square)

    def broadcast(self, vec, tree):
        """Expand a per-layer (L,) vector to a per-leaf multiplier tree."""
        return self._broadcast_fn(vec, tree)

    def moments(self, tree):
        """(sum, sum_sq, count) per layer — feeds the variance EMA."""
        return self.sums(tree, False), self.sums(tree, True), self.counts

    def mean(self, tree, square: bool = False) -> torch.Tensor:
        c = self.counts
        s = self.sums(tree, square)
        return s / torch.clamp_min(c.to(s.device), 1.0)


def _leaf_sum(tree, square: bool) -> torch.Tensor:
    tot = None
    for l in tu.leaves(tree):
        if not l.dtype.is_floating_point:
            continue
        x = l.float()
        s = (x * x if square else x).sum()
        tot = s if tot is None else tot + s
    return tot if tot is not None else torch.zeros(())


def flat_grouping(params, top_keys: bool = True) -> LayerGrouping:
    """Grouping by sorted top-level keys (vision models / generic trees)."""
    keys = sorted(params.keys())
    counts = torch.tensor(
        [float(sum(l.numel() for l in tu.leaves(params[k]))) for k in keys],
        dtype=torch.float32)

    def sums_fn(tree, square: bool) -> torch.Tensor:
        return torch.stack([_leaf_sum(tree[k], square)
                            for k in keys]).float()

    def broadcast_fn(vec, tree):
        return {k: tu.tree_map(lambda l, i=i: vec[i], tree[k])
                for i, k in enumerate(keys)}

    return LayerGrouping(len(keys), sums_fn, counts, list(keys), broadcast_fn)


def _layer_sums(tree, square: bool) -> torch.Tensor:
    """(n,) f32 sums over the floating leaves of a stacked tree, one per
    entry of the leading layer axis."""
    tot = None
    for l in tu.leaves(tree):
        if not l.dtype.is_floating_point:
            continue
        x = l.float()
        s = (x * x if square else x).reshape(x.shape[0], -1).sum(dim=1)
        tot = s if tot is None else tot + s
    return tot


def lm_grouping(params, stack_cfg) -> LayerGrouping:
    """Grouping for ``models.lm`` params ``{embed, stack: {segK}, final_norm,
    ...}``. Counts come from shapes only (meta tensors work); ``broadcast``
    takes a numpy or torch (L,) vector and shape-only leaves."""
    L = stack_cfg.num_layers
    total = L + 2
    counts = [0.0] * total
    names = [""] * L
    offs, off = [], 0
    for si, (defs, n) in enumerate(stack_cfg.segments):
        offs.append(off)
        k = len(defs)
        for r in range(n):
            for i, bd in enumerate(defs):
                names[off + r * k + i] = f"seg{si}.r{r}.b{i}({bd.kind})"
        for i in range(k):
            leaves = tu.leaves(params["stack"][f"seg{si}"][f"b{i}"])
            per_layer = sum(l.numel() / l.shape[0] for l in leaves)
            for r in range(n):
                counts[off + r * k + i] = float(per_layer)
        off += n * k
    embed_keys = [k for k in ("embed", "frontend_proj") if k in params]
    head_keys = [k for k in ("final_norm", "unembed", "enc_norm")
                 if k in params]
    counts[L] = float(sum(l.numel() for k in embed_keys
                          for l in tu.leaves(params[k])))
    counts[L + 1] = float(sum(l.numel() for k in head_keys
                              for l in tu.leaves(params[k])))

    def layer_ids(si: int, i: int, n: int, k: int) -> np.ndarray:
        return offs[si] + np.arange(n) * k + i

    def sums_fn(tree, square: bool) -> torch.Tensor:
        parts = [None] * total
        for si, (defs, n) in enumerate(stack_cfg.segments):
            k = len(defs)
            for i in range(k):
                s = _layer_sums(tree["stack"][f"seg{si}"][f"b{i}"], square)
                for r, li in enumerate(layer_ids(si, i, n, k)):
                    parts[li] = s[r]
        parts[L] = _leaf_sum({k: tree[k] for k in embed_keys if k in tree},
                             square)
        parts[L + 1] = _leaf_sum({k: tree[k] for k in head_keys
                                  if k in tree}, square)
        dev = parts[0].device
        return torch.stack([p.to(dev) for p in parts]).float()

    def broadcast_fn(vec, tree):
        out = {}
        for key in tree:
            if key == "stack":
                stk = {}
                for si, (defs, n) in enumerate(stack_cfg.segments):
                    k = len(defs)
                    seg = {}
                    for i in range(k):
                        v = vec[layer_ids(si, i, n, k)]
                        seg[f"b{i}"] = tu.tree_map(
                            lambda l, v=v: v.reshape(
                                (n,) + (1,) * (l.ndim - 1)),
                            tree["stack"][f"seg{si}"][f"b{i}"])
                    stk[f"seg{si}"] = seg
                out["stack"] = stk
            else:
                li = L if key in embed_keys else L + 1
                out[key] = tu.tree_map(lambda l, li=li: vec[li], tree[key])
        return out

    return LayerGrouping(total, sums_fn,
                         torch.tensor(counts, dtype=torch.float32),
                         names + ["embed", "head"], broadcast_fn)
