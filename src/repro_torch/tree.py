"""Sorted-key flatten/unflatten over nested dicts — the port's stand-in for
``jax.tree_util``.

Leaf order equals ``jax.tree_util.tree_flatten`` order for dict trees: keys
are sorted at every level (so ``bn_stem < fc < s0b0 < ... < stem`` and
``bias < scale``). Lists, tuples and NamedTuples keep their order (a
NamedTuple unflattens to its own class); anything else is a leaf. The slab layout (``kernels.layout``) depends on this order, since it
fixes every leaf's row range and therefore the per-row layer ids.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = None


def _flatten_into(t, leaves: List[Any]):
    if isinstance(t, dict):
        keys = sorted(t.keys())
        return ("dict", tuple(keys),
                tuple(_flatten_into(t[k], leaves) for k in keys))
    if isinstance(t, (list, tuple)):
        kind = type(t) if _is_namedtuple(t) else type(t).__name__
        return (kind, len(t), tuple(_flatten_into(x, leaves) for x in t))
    leaves.append(t)
    return _LEAF


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def flatten(tree) -> Tuple[List[Any], Any]:
    """-> (leaves, treedef)."""
    leaves: List[Any] = []
    return leaves, _flatten_into(tree, leaves)


# The walks are module-level functions, not closures that call themselves:
# a self-referencing closure is a reference cycle that would keep every
# leaf it saw alive until the cyclic garbage collector runs.
def _build(d, it):
    if d is _LEAF:
        return next(it)
    kind, meta, children = d
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(meta, children)}
    seq = [_build(c, it) for c in children]
    if kind == "list":
        return seq
    return tuple(seq) if kind == "tuple" else kind(*seq)


def unflatten(treedef, leaves) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the treedef holds")
    return out


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def _paths_into(t, prefix: Tuple, out: List[Tuple]):
    if isinstance(t, dict):
        for k in sorted(t.keys()):
            _paths_into(t[k], prefix + (k,), out)
    elif isinstance(t, (list, tuple)):
        for i, x in enumerate(t):
            _paths_into(x, prefix + (i,), out)
    else:
        out.append(prefix)


def paths(tree) -> List[Tuple]:
    """Each leaf's path, in leaf order: the tuple of dict keys (and list
    or tuple indices) from the root, as ``jax.tree_util``'s key paths
    without their wrappers."""
    out: List[Tuple] = []
    _paths_into(tree, (), out)
    return out


def _keystrs_into(t, prefix: str, out: List[str]):
    if isinstance(t, dict):
        for k in sorted(t.keys()):
            _keystrs_into(t[k], f"{prefix}[{k!r}]", out)
    elif _is_namedtuple(t):
        for f, x in zip(t._fields, t):
            _keystrs_into(x, f"{prefix}.{f}", out)
    elif isinstance(t, (list, tuple)):
        for i, x in enumerate(t):
            _keystrs_into(x, f"{prefix}[{i}]", out)
    else:
        out.append(prefix)


def keystrs(tree) -> List[str]:
    """Each leaf's key path in leaf order, spelled as
    ``jax.tree_util.keystr`` spells it: ``.field`` for a NamedTuple's
    field, ``['k']`` for a dict key, ``[i]`` for a list or tuple index
    (``.params['bn_stem']['bias']``, ``.control.codes``). Checkpoint
    manifests are keyed by these strings in both packages."""
    out: List[str] = []
    _keystrs_into(tree, "", out)
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """Map ``fn`` over the leaves of ``tree`` (and of same-shaped ``rest``)."""
    ls, td = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(td, [fn(*xs) for xs in zip(ls, *others)])
