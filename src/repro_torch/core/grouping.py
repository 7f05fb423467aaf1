"""Per-layer parameter grouping — maps model param trees to the (L,) layer
vectors the Tri-Accel controller operates on. Only ``flat_grouping`` (the
vision grouping, by sorted top-level keys) is ported so far."""
from __future__ import annotations

from typing import Callable, List

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
