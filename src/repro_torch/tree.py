"""Sorted-key flatten/unflatten over nested dicts — the port's stand-in for
``jax.tree_util``.

Leaf order equals ``jax.tree_util.tree_flatten`` order for dict trees: keys
are sorted at every level (so ``bn_stem < fc < s0b0 < ... < stem`` and
``bias < scale``). Lists and tuples keep their order; anything else is a
leaf. The slab layout (``kernels.layout``) depends on this order, since it
fixes every leaf's row range and therefore the per-row layer ids.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = None


def flatten(tree) -> Tuple[List[Any], Any]:
    """-> (leaves, treedef)."""
    leaves: List[Any] = []

    def rec(t):
        if isinstance(t, dict):
            keys = sorted(t.keys())
            return ("dict", tuple(keys), tuple(rec(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, len(t), tuple(rec(x) for x in t))
        leaves.append(t)
        return _LEAF

    return leaves, rec(tree)


def unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def rec(d):
        if d is _LEAF:
            return next(it)
        kind, meta, children = d
        if kind == "dict":
            return {k: rec(c) for k, c in zip(meta, children)}
        seq = [rec(c) for c in children]
        return seq if kind == "list" else tuple(seq)

    out = rec(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the treedef holds")
    return out


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """Map ``fn`` over the leaves of ``tree`` (and of same-shaped ``rest``)."""
    ls, td = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(td, [fn(*xs) for xs in zip(ls, *others)])
