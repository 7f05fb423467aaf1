"""The ``SlabView`` layout layer the fused update phase sweeps over, and
the reference's tile folding for the reduction kernels (``fold2d``,
``small_blocks``).

Every floating leaf of a ``LayerGrouping``-shaped tree is assigned a
contiguous row range of ONE (rows, SLAB_N) slab, with stacked segment
leaves (leading layer axis) split so each layer's elements start on a row
boundary. The index metadata — row offsets and a per-row int32 layer-id
vector — is built once (numpy) and cached, so the per-step work is views
and per-row gathers of tiny (L,) tables.

``fold2d``/``small_blocks`` are the reference's (rows, cols) tiling of
any-shaped tensors for its TPU reductions, kept here as plain functions
equal to the reference for every size; the CUDA ``grad_stats`` kernel
reads the flat tensor with a bounds-checked tail and needs neither.

Leaf order is the sorted-key order of ``repro_torch.tree`` (equal to
``jax.tree_util`` order), so a tree packs into the same rows as in the
reference package, element for element.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tree as tu

SLAB_M = 256    # tile rows of the fused-update sweep (row-metadata blocks)
SLAB_N = 512    # slab width (lanes)


def fold2d(x: torch.Tensor, block_m: int, cols: int,
           min_rows: int = 0) -> torch.Tensor:
    """Flatten ``x`` to (rows, cols) with rows a multiple of ``block_m``
    (and >= ``min_rows``), zero-padding the tail only when needed."""
    n = x.numel()
    rows = -(-n // cols)
    pad_rows = max(-(-rows // block_m) * block_m, min_rows)
    if n == pad_rows * cols:
        return x.reshape(pad_rows, cols)        # aligned: no pad copy
    out = torch.zeros((pad_rows * cols,), dtype=x.dtype, device=x.device)
    out[:n] = x.reshape(-1)
    return out.reshape(pad_rows, cols)


def small_blocks(n: int, block_m: int = SLAB_M,
                 block_n: int = SLAB_N) -> Tuple[int, int]:
    """(rows, cols) tile for an ``n``-element reduction: full tiles for
    tensors that fill one, a single small tile otherwise (16-row multiple,
    at least 16 rows)."""
    if n >= block_m * block_n:
        return block_m, block_n
    cols = block_n if n >= 8 * block_n else 128
    rows = -(-n // cols)
    rows = -(-rows // 16) * 16
    return min(block_m, max(rows, 16)), cols


@dataclasses.dataclass(frozen=True)
class _LeafSlot:
    shape: Tuple[int, ...]
    floating: bool
    stack: int = 1          # leading stacked-layer extent (1 = unstacked)
    elems: int = 0          # elements per stacked entry
    rows_per: int = 0       # slab rows per stacked entry (lane-padded)
    row_off: int = 0        # first slab row of this leaf
    layers: Tuple[int, ...] = ()   # layer id per stacked entry


class _Unpack(torch.autograd.Function):
    """Slab -> leaf views whose backward writes every leaf gradient into
    ONE slab-shaped buffer: the gradient is born in slab layout (autograd's
    per-slice backward would materialize a full zero slab per leaf)."""

    @staticmethod
    def forward(ctx, slab, view):
        ctx.view = view
        return tuple(view._leaf_view(slab, s) for s in view.slots
                     if s.floating)

    @staticmethod
    def backward(ctx, *grads):
        view = ctx.view
        ref = next(g for g in grads if g is not None)
        out = torch.zeros((view.rows, SLAB_N), dtype=ref.dtype,
                          device=ref.device)
        fl = [s for s in view.slots if s.floating]
        for slot, g in zip(fl, grads):
            if g is not None:
                view._leaf_view(out, slot).copy_(g)
        return out, None


class SlabView:
    """One (rows, SLAB_N) slab view over a params-shaped tree.

    Rows are ordered leaf-major (stacked entries contiguous within a leaf);
    per-row ``row_layer`` metadata carries the grouping."""

    def __init__(self, treedef, slots: List[_LeafSlot], rows: int,
                 row_layer: np.ndarray, num_layers: int, shards: int = 1):
        self.treedef = treedef
        self.slots = slots
        self.rows = rows                        # padded to SLAB_M * shards
        self.row_layer = row_layer              # (rows,) int32
        self.num_layers = num_layers
        self.shards = shards
        self._dev_rows: Dict[torch.device, torch.Tensor] = {}

    # ---------------------------------------------------------- build -----
    @staticmethod
    def build(tree, grouping, block_m: int = SLAB_M, lane: int = SLAB_N,
              shards: int = 1) -> "SlabView":
        """Index metadata for ``tree`` under ``grouping``'s layer map. Only
        shapes and dtypes are read (meta tensors work)."""
        leaves, treedef = tu.flatten(tree)
        ids_leaves = tu.leaves(grouping.broadcast(
            np.arange(grouping.num_layers), tree))
        slots: List[_LeafSlot] = []
        row_layer: List[np.ndarray] = []
        off = 0
        for leaf, ids in zip(leaves, ids_leaves):
            if not leaf.dtype.is_floating_point:
                slots.append(_LeafSlot(tuple(leaf.shape), False))
                continue
            ids = np.asarray(ids)
            stack = int(ids.shape[0]) if ids.ndim else 1
            per = (ids.reshape(stack, -1)[:, 0].astype(np.int32)
                   if ids.ndim else np.asarray([int(ids)], np.int32))
            n = int(np.prod(leaf.shape)) if len(leaf.shape) else 1
            elems = n // stack
            rows_per = -(-elems // lane)
            slots.append(_LeafSlot(tuple(leaf.shape), True, stack, elems,
                                   rows_per, off, tuple(int(i) for i in per)))
            row_layer.append(np.repeat(per, rows_per))
            off += stack * rows_per
        quantum = block_m * max(int(shards), 1)
        rows = -(-off // quantum) * quantum if off else quantum
        ids_full = np.zeros((rows,), np.int32)   # tail pad rows -> layer 0
        if off:
            ids_full[:off] = np.concatenate(row_layer)
        return SlabView(treedef, slots, rows, ids_full, grouping.num_layers,
                        max(int(shards), 1))

    # ---------------------------------------------------- pack / unpack ---
    def pack(self, tree, dtype=torch.float32) -> torch.Tensor:
        """Assemble the (rows, SLAB_N) slab; ragged leaves and the tail pad
        with zeros (absorbing for every fused-update statistic)."""
        return self.pack_consuming(tu.leaves(tree), dtype)

    def pack_consuming(self, leaves: list, dtype=torch.float32
                       ) -> torch.Tensor:
        """``pack`` of the tree's flat leaf list, emptied as it goes: a
        leaf the caller holds nowhere else is freed once it is copied, so
        a model's tree and its slab are never whole together."""
        dev = next(x.device for x in leaves)
        out = torch.zeros((self.rows, SLAB_N), dtype=dtype, device=dev)
        for slot in self.slots:
            x = leaves.pop(0)
            if slot.floating:
                self._leaf_view(out, slot).copy_(x)
            del x
        return out

    def _leaf_view(self, slab: torch.Tensor, slot: _LeafSlot) -> torch.Tensor:
        rows = slot.stack * slot.rows_per
        y = slab[slot.row_off:slot.row_off + rows]
        y = y.reshape(slot.stack, slot.rows_per * SLAB_N)[:, :slot.elems]
        return y.reshape(slot.shape)

    def unpack(self, slab: torch.Tensor, like) -> Any:
        """Slice the slab back into a ``like``-shaped tree of views
        (non-floating leaves pass through from ``like``). Differentiable:
        the gradient w.r.t. ``slab`` comes back as one slab."""
        ref_leaves = tu.leaves(like)
        if slab.requires_grad:
            views = iter(_Unpack.apply(slab, self))
        else:
            views = iter(self._leaf_view(slab, s) for s in self.slots
                         if s.floating)
        out = [next(views) if s.floating else ref
               for s, ref in zip(self.slots, ref_leaves)]
        return tu.unflatten(self.treedef, out)

    # -------------------------------------------------- row partition -----
    def row_ranges(self) -> Tuple[Tuple[int, int], ...]:
        """``shards`` equal contiguous [lo, hi) row ranges, each a multiple
        of SLAB_M rows."""
        per = self.rows // self.shards
        return tuple((i * per, (i + 1) * per) for i in range(self.shards))

    # ------------------------------------------------- per-row metadata ---
    def _rows_on(self, device) -> torch.Tensor:
        dev = torch.device(device)
        t = self._dev_rows.get(dev)
        if t is None:
            t = torch.from_numpy(self.row_layer).to(dev)
            self._dev_rows[dev] = t
        return t

    def row_blocks(self, device="cpu", block_m: int = SLAB_M) -> torch.Tensor:
        """Static per-row layer ids as (n_tiles, block_m) int32."""
        return self._rows_on(device).reshape(-1, block_m)

    def gather_rows(self, table: torch.Tensor,
                    block_m: int = SLAB_M) -> torch.Tensor:
        """Per-row values of a per-layer (L,) table, shaped (n_tiles,
        block_m)."""
        return table[self._rows_on(table.device)].reshape(-1, block_m)

    def amax_tree(self, table: torch.Tensor, like) -> Any:
        """Per-leaf scalar absmax from a per-layer (L,) table (max over the
        layers a stacked leaf spans)."""
        out = []
        for slot, _ in zip(self.slots, tu.leaves(like)):
            if not slot.floating:
                out.append(torch.zeros((), device=table.device))
                continue
            idx = torch.as_tensor(slot.layers, device=table.device)
            out.append(table[idx].max())
        return tu.unflatten(self.treedef, out)


_VIEW_CACHE: Dict[Any, Tuple[SlabView, Any]] = {}


def slab_view(tree, grouping, shards: int = 1) -> SlabView:
    """``SlabView.build`` cached on (treedef, leaf shapes/dtypes, grouping
    identity, shards); the entry pins the grouping so its id() cannot be
    recycled while the key is live."""
    leaves, treedef = tu.flatten(tree)
    key = (repr(treedef), tuple((tuple(l.shape), str(l.dtype))
                                for l in leaves), id(grouping), int(shards))
    hit = _VIEW_CACHE.get(key)
    if hit is None:
        hit = (SlabView.build(tree, grouping, shards=shards), grouping)
        _VIEW_CACHE[key] = hit
    return hit[0]
