"""Serving engine: the (rung, precision-tier) decode / admit / chunk /
repack / infer paths and the per-tier weight sets, as
``repro/serve/engine.py``.

PyTorch runs eagerly, so there is nothing to compile: ``warm()`` runs each
path the session can dispatch once on scratch caches (or scratch images)
and records the peak bytes the allocator held while it ran into
``measured`` (the reference harvests each executable's
``memory_analysis()``). ``compile_count`` counts the paths as the
reference's executable cache does: the first run of each key
(``("decode" | "admit" | "chunk" | "infer", rung, tier)``,
``("repack", from, to)``), whether ``warm()`` or a dispatch ran it, so a
session that dispatches only warmed paths keeps it unchanged; ``compile_s``
sums those first runs' wall seconds, where the reference sums its
compiles. CUDA graphs of the paths come later.

Precision ladder for decode weights (the serving side of §3.1):

    tier 2  fp32   weights as trained
    tier 1  bf16   cast
    tier 0  fp8    rounded by the tier-cast kernel (``kernels.ops.qdq_cast``,
                   one absmax per leaf on the tpu ladder; fp16 rounding on
                   the gpu ladder), carried in a bf16 container

Caches are updated in place where the reference donates them: ``decode``,
``admit`` and ``chunk_admit`` write the caches they are given and return
them.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.core.batch_scaler import measured_peak_bytes
from repro_torch.train.task import TensorSpec


def tier_params(params, tier: int, ladder: str = "tpu", amax_tree=None,
                device=None):
    """Weight set for one serving precision tier (floating leaves only).
    ``amax_tree`` (params-shaped scalars): known per-leaf absmax for the
    tier-0 cast. A stacked leaf (layers, ...) gets ONE absmax over all its
    layers, as the reference casts each leaf whole. With ``device``, each
    leaf moves there before its cast, one leaf at a time, so masters kept
    on the host never sit on the card whole (a 15.7 B-parameter model's
    f32 masters and one of its bf16 sets do not fit one card together)."""
    from repro_torch.kernels import ops

    def one(x, amax=None):
        if device is not None:
            x = x.to(device)
        if not x.is_floating_point():
            return x
        if tier == 2:
            return x.float()
        if tier == 1:
            return x.to(torch.bfloat16)
        return ops.qdq_cast(x.float(), 0, ladder=ladder, amax=amax,
                            out_dtype=torch.bfloat16)
    if amax_tree is not None:
        return tu.tree_map(one, params, amax_tree)
    return tu.tree_map(one, params)


def _map_named(fn, tree, *rest, name=""):
    """``fn(name, leaf, *rest_leaves)`` over dict trees, ``name`` the leaf's
    own key."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, tree[k], *(r[k] for r in rest), name=k)
                for k in sorted(tree)}
    return fn(name, tree, *rest)


#: cache leaves indexed by sequence slot, (layers, B, L, ...): attention's
#: keys, values and positions, MLA's compressed cache. Every other leaf
#: (the recurrent blocks' ``ssm``, ``conv`` and ``h``) is a state row that
#: a decode step overwrites whole.
SEQUENCE_LEAVES = frozenset({"k", "v", "pos", "ckv", "kr"})


def _named_leaves(tree, name=""):
    """[(the leaf's own key, leaf)] in the sorted-key leaf order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_leaves(tree[k], k)]
    return [(name, tree)]


def scatter_prefill(caches, pre, slot: int):
    """Scatter ONE request's prefill caches (batch dim 1) into row ``slot``
    of the batched decode caches, in place; returns ``caches``.

    Leaves are stacked per segment, (layers, B, ...). A leaf whose per-row
    shape matches is written directly; a sequence-indexed leaf (K, V,
    positions) is ring-mapped: prefill wrote positions [0, P), the decode
    cache holds L slots at position % L, and slots the prompt does not
    reach are reset (position -1 = masked), so nothing of the row's
    previous occupant leaks."""
    def write(name, c, p):
        if p.shape[2:] == c.shape[2:]:
            c[:, slot] = p[:, 0].to(c.dtype)
            return c
        P, L = p.shape[2], c.shape[2]
        keep = torch.arange(max(0, P - L), P, device=c.device)
        row = c[:, slot]
        row.fill_(-1 if name == "pos" else 0)
        row[:, keep % L] = p[:, 0, keep].to(c.dtype)
        return c
    return _map_named(write, caches, pre)


def repack_caches(caches, src, valid):
    """Re-batch caches onto a new rung: row j of the result is row
    ``src[j]`` of the input where ``valid[j]``, else the empty-slot value
    (pos = -1). Returns new tensors, one a leaf and no temporary: the
    repack's peak is the input and the output caches."""
    def one(name, c):
        t = c.index_select(1, src.long())
        mask = valid.reshape((1, valid.shape[0]) + (1,) * (t.ndim - 2))
        return t.masked_fill_(~mask, -1 if name == "pos" else 0)
    return _map_named(one, caches)


class ServeEngine:
    """The serving paths and the precision ladder for one task: decode and
    whole-prompt or chunked admission for a token task, batched inference
    for a cache-free one (``aux_state``: its BatchNorm statistics)."""

    def __init__(self, task, params, aux_state=None, *, total_len: int,
                 prompt_len: int, rungs: Sequence[int],
                 tiers: Sequence[int] = (1,), ladder: str = "tpu",
                 cache_dtype=torch.bfloat16, amax_tree=None,
                 prefill_chunk: Optional[int] = None, device=None):
        if list(rungs) != sorted(set(rungs)) or not rungs:
            raise ValueError(f"rungs must be sorted and unique: {rungs}")
        self.task = task
        self.device = torch.device(device) if device is not None \
            else task.device
        self.total_len = int(total_len)
        self.prompt_len = int(prompt_len)
        self.rungs = tuple(int(r) for r in rungs)
        self.tiers = tuple(sorted(set(int(t) for t in tiers)))
        self.ladder = ladder
        self.cache_dtype = cache_dtype
        self.aux_state = aux_state if aux_state is not None else {}
        self.params_by_tier = {t: tier_params(params, t, ladder,
                                              amax_tree=amax_tree,
                                              device=self.device)
                               for t in self.tiers}
        self.input_spec = task.serve_input_spec(self.prompt_len)
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        #: peak allocated bytes while each path ran in ``warm()``, keyed as
        #: the reference's executables: ("decode", rung, tier), ...
        self.measured: Dict[Tuple, float] = {}
        self.compile_count = 0        # distinct path keys run so far
        self.compile_s = 0.0          # wall seconds of their first runs
        #: how often each path ran to its end, warm-ups included
        self.runs = {"decode": 0, "admit": 0, "chunk": 0, "infer": 0,
                     "repack": 0}
        #: prompt tokens the chunk path ran through the decode hook
        self.chunk_tokens = 0
        self._seen: set = set()

    @property
    def supports_chunked(self) -> bool:
        """Chunked prefill runs the prompt through the decode hook, so it
        covers every tokens-only task."""
        return self.task.serves_tokens and set(self.input_spec) == {"tokens"}

    @property
    def chunked(self) -> bool:
        return self.prefill_chunk is not None and self.supports_chunked

    # ------------------------------------------------------------ shapes --
    def _batch_spec(self, rung: int) -> Dict[str, TensorSpec]:
        return {k: TensorSpec((rung,) + tuple(v.shape[1:]), v.dtype)
                for k, v in self.input_spec.items()}

    def init_caches(self, rung: int):
        """Empty caches for ``rung`` slots on the engine's device (None for
        a task without a cache)."""
        if not self.task.serves_tokens:
            return None
        return self.task.init_cache(self._batch_spec(rung), self.total_len,
                                    dtype=self.cache_dtype,
                                    device=self.device)

    def measured_bytes(self, rung: int, tier: int) -> Optional[float]:
        """Measured footprint at (rung, tier): the max over the steady-state
        paths warmed there (decode and admit or chunk for a token task,
        infer for a cache-free one; a repack is a transient between two
        rungs); None before ``warm()`` (and on the CPU)."""
        keys = (("decode", rung, tier), ("admit", rung, tier),
                ("chunk", rung, tier), ("infer", rung, tier))
        vals = [self.measured[k] for k in keys if k in self.measured]
        return max(vals) if vals else None

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    @contextlib.contextmanager
    def _path(self, key):
        """Count ``key``'s first run, where the reference compiles its
        executable (``_get``): before the path runs, so a dispatch that
        fails still counts; that run's wall seconds go to ``compile_s``."""
        if key in self._seen:
            yield
            return
        self._seen.add(key)
        self.compile_count += 1
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.compile_s += time.perf_counter() - t0

    # ------------------------------------------------------------- paths --
    @torch.no_grad()
    def decode(self, rung, tier, caches, token, index, valid=None):
        """One greedy decode step of every slot at its own position ->
        (next tokens (rung,) int32, caches updated in place). Rows where
        ``valid`` is False keep their cache rows bit-identical, also when
        the step fails part way (an out-of-memory error after some layers
        wrote their rows)."""
        from repro_torch.train.serve import make_decode_fn
        index_np = np.asarray(index, np.int64).reshape(rung)
        token_t = self._tensor(token, torch.int32).reshape(rung)
        index_t = self._tensor(index_np, torch.int32)
        inv = (np.flatnonzero(~np.asarray(valid, bool).reshape(rung))
               if valid is not None else np.zeros((0,), np.int64))
        saved = []
        if inv.size:
            # keep what the step writes in the invalid rows and put it back
            # after (the reference selects the old rows with
            # jnp.where(valid, new, old)): a sequence leaf's slot index % L,
            # L that leaf's own length (a windowed layer's ring is shorter
            # than the cache), and a state leaf's whole row
            rows = self._tensor(inv, torch.int64)
            for name, c in _named_leaves(caches):
                at = (rows,)
                if name in SEQUENCE_LEAVES:
                    at = (rows, self._tensor(index_np[inv] % c.shape[2],
                                             torch.int64))
                saved.append((c, at, c[(slice(None),) + at].clone()))
        with self._path(("decode", rung, tier)):
            try:
                out, caches = make_decode_fn(self.task)(
                    self.params_by_tier[tier], caches, token_t, index_t)
            finally:
                for c, at, old in saved:
                    c[(slice(None),) + at] = old
        self.runs["decode"] += 1
        return out, caches

    @torch.no_grad()
    def admit(self, rung, tier, caches, slot, batch1):
        """Prefill one request (batch dim 1) and scatter its caches into row
        ``slot`` -> (its first token, caches updated in place)."""
        with self._path(("admit", rung, tier)):
            batch1 = {k: self._tensor(v, self.input_spec[k].dtype)
                      for k, v in batch1.items()}
            logits, pre = self.task.prefill(self.params_by_tier[tier],
                                            batch1)
            caches = scatter_prefill(caches, pre, int(slot))
        self.runs["admit"] += 1
        return torch.argmax(logits[0], dim=-1).to(torch.int32), caches

    @torch.no_grad()
    def chunk_admit(self, rung, tier, caches, slot, tokens, start, nvalid,
                    fresh):
        """One prefill chunk of the request in ``slot``: ``tokens`` is the
        (prefill_chunk,)-padded prompt slice from position ``start`` with
        ``nvalid`` real lanes, teacher-forced one at a time through the
        task's decode hook at batch 1 on views of the slot's cache rows,
        so every write lands in ``caches`` in place; ``fresh`` (the first
        chunk) clears the rows first (positions -1, K/V zero), so nothing
        of the slot's previous occupant leaks. The reference scans all
        lanes and masks the pad lanes to no-ops; stopping at ``nvalid``
        leaves the same state. -> (argmax of the last real lane's logits,
        the request's first token once the final chunk lands; caches)."""
        with self._path(("chunk", rung, tier)):
            slot, start, nvalid = int(slot), int(start), int(nvalid)
            row = tu.tree_map(lambda c: c[:, slot:slot + 1], caches)
            if fresh:
                _map_named(lambda name, r: r.fill_(-1 if name == "pos"
                                                   else 0), row)
            toks = self._tensor(np.asarray(tokens)[:nvalid], torch.int32)
            pos = torch.arange(start, start + nvalid, dtype=torch.int32,
                               device=self.device)
            last = None
            for j in range(nvalid):
                last, _ = self.task.decode(self.params_by_tier[tier], row,
                                           toks[j:j + 1], pos[j:j + 1])
            tok = (torch.argmax(last[0].float()).to(torch.int32)
                   if last is not None else
                   torch.zeros((), dtype=torch.int32, device=self.device))
        self.runs["chunk"] += 1
        self.chunk_tokens += nvalid
        return tok, caches

    @torch.no_grad()
    def repack(self, r_from, r_to, caches, src, valid):
        with self._path(("repack", r_from, r_to)):
            out = repack_caches(caches, self._tensor(src, torch.int64),
                                self._tensor(valid, torch.bool))
        self.runs["repack"] += 1
        return out

    @torch.no_grad()
    def infer(self, rung, tier, batch):
        """Cache-free batched inference of ``rung`` inputs -> (argmax
        (rung,) int32, logits (rung, classes) f32)."""
        from repro_torch.train.serve import make_infer_fn
        with self._path(("infer", rung, tier)):
            batch = {k: self._tensor(v, self.input_spec[k].dtype)
                     for k, v in batch.items()}
            out = make_infer_fn(self.task)(self.params_by_tier[tier],
                                           self.aux_state, batch)
        self.runs["infer"] += 1
        return out

    # ------------------------------------------------------------- warm ---
    def _warm_path(self, key, fn):
        _, peak = measured_peak_bytes(fn, self.device)
        if peak is not None:
            self.measured[key] = peak

    def warm(self) -> int:
        """Run every path the session can dispatch once on scratch caches:
        decode plus admit (whole-prompt) or chunk (chunked prefill) per
        (rung, tier), infer for a cache-free task, repack per ordered rung
        pair for a token task; ``measured`` then holds each path's peak
        allocated bytes (on the card). Returns ``compile_count``: the
        paths run so far."""
        for rung in self.rungs:
            zeros = np.zeros((rung,), np.int32)
            for tier in self.tiers:
                if not self.task.serves_tokens:
                    batch = {k: np.zeros((rung,) + tuple(v.shape[1:]),
                                         np.float32)
                             for k, v in self.input_spec.items()}
                    self._warm_path(("infer", rung, tier), lambda: self.infer(
                        rung, tier, batch))
                    continue
                caches = self.init_caches(rung)
                self._warm_path(("decode", rung, tier), lambda: self.decode(
                    rung, tier, caches, zeros, zeros))
                if self.chunked:
                    # one lane: the path's code and its peak bytes, at a
                    # prompt token's cost, not a chunk's
                    C = self.prefill_chunk
                    self._warm_path(("chunk", rung, tier),
                                    lambda: self.chunk_admit(
                                        rung, tier, caches, 0,
                                        np.zeros((C,), np.int32), 0, 1,
                                        True))
                else:
                    prompt = {k: np.zeros(v.shape, np.int64)
                              for k, v in self.input_spec.items()}
                    self._warm_path(("admit", rung, tier),
                                    lambda: self.admit(rung, tier, caches, 0,
                                                       prompt))
                del caches
        if not self.task.serves_tokens:
            return self.compile_count
        for a in self.rungs:
            caches = self.init_caches(a)
            for b in self.rungs:
                if a != b:
                    src = np.arange(b, dtype=np.int64) % a
                    self._warm_path(("repack", a, b), lambda: self.repack(
                        a, b, caches, src, np.ones((b,), bool)))
            del caches
        return self.compile_count
