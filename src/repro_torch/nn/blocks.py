"""Block and stack composition, as ``repro/nn/blocks.py``.

A trunk is a sequence of *segments*, each a group of blocks repeated N
times. Parameters of a segment are stacked with a leading layer axis (the
reference's ``lax.scan`` layout, so weights cross unchanged); the port
walks that axis with a Python loop. Caches are stacked the same way,
(layers, B, ...), and updated in place by decode.

Ported so far: ``gqa`` mixing with the dense gated FFN, in the ``train``,
``prefill`` and ``decode`` modes. In train mode each layer runs under
``torch.utils.checkpoint`` when ``remat`` (the reference's
``jax.checkpoint``), so backward recomputes it; the in-loss precision
emulation (``codes``/``qdq_fn`` of ``reference_step``) rounds each layer's
weights inside that checkpoint. MLA, SSM, RG-LRU, MoE and
cross-attention blocks wait for their slices.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tu
from repro_torch.nn import attention as attn_lib
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.layers import (activation, dense, dense_init, rmsnorm,
                                   rmsnorm_init)
from repro_torch.nn.module import stack_init as _stacked


@dataclasses.dataclass(frozen=True)
class BlockDef:
    kind: str                 # "gqa" (others wait for their slices)
    ffn: str = "dense"        # "dense" | "moe" | "none"
    window: int = 0           # 0 = global attention; > 0 = sliding window
    cross: bool = False       # decoder block with cross-attention


@dataclasses.dataclass(frozen=True)
class StackConfig:
    segments: Tuple[Tuple[Tuple[BlockDef, ...], int], ...]
    d_model: int
    d_ff: int
    attn: Optional[AttnConfig] = None
    act: str = "silu"
    gated: bool = True        # SwiGLU-style gated FFN vs plain 2-matrix MLP
    norm_eps: float = 1e-6
    remat: bool = True

    @property
    def num_layers(self) -> int:
        return sum(len(defs) * n for defs, n in self.segments)


def _check_block(bd: BlockDef) -> None:
    if bd.kind != "gqa" or bd.ffn not in ("dense", "none") or bd.cross:
        raise NotImplementedError(
            f"block {bd} is not ported yet: the port runs gqa blocks with "
            "dense FFNs (the other kinds come with their architectures)")


# ------------------------------------------------------------------ FFN ----
def ffn_init(gen, d_model, d_ff, gated=True, device="cpu"):
    p = {"w_up": dense_init(gen, d_model, d_ff, device=device),
         "w_down": dense_init(gen, d_ff, d_model, device=device)}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, device=device)
    return p


def ffn_apply(p, x, act_name):
    act = activation(act_name)
    if "w_gate" in p:
        h = act(dense(p["w_gate"], x)) * dense(p["w_up"], x)
    else:
        h = act(dense(p["w_up"], x))
    return dense(p["w_down"], h)


# ---------------------------------------------------------------- block ----
def block_init(gen, bd: BlockDef, sc: StackConfig, device="cpu"):
    _check_block(bd)
    p: Dict[str, Any] = {"norm1": rmsnorm_init(gen, sc.d_model, device),
                         "mix": attn_lib.gqa_init(gen, sc.attn, device)}
    if bd.ffn != "none":
        p["norm2"] = rmsnorm_init(gen, sc.d_model, device)
        p["ffn"] = ffn_init(gen, sc.d_model, sc.d_ff, sc.gated, device)
    return p


def block_init_cache(bd: BlockDef, sc: StackConfig, batch: int, length: int,
                     dtype=torch.bfloat16, device="cpu"):
    """Decode-time cache for one block."""
    _check_block(bd)
    L = min(length, bd.window) if bd.window > 0 else length
    return {"mix": attn_lib.gqa_init_cache(sc.attn, batch, L, dtype,
                                           device)}


def _block_fwd(p, x, pos, bd: BlockDef, sc: StackConfig, mode: str,
               cache=None, index=None, segments=None):
    """-> (x, new_cache) for one block in {train, prefill, decode}; the
    cache is None in train mode."""
    _check_block(bd)
    h = rmsnorm(p["norm1"], x, sc.norm_eps)
    window = bd.window or None
    c = None
    if mode == "decode":
        y, c = attn_lib.gqa_decode(p["mix"], h, cache["mix"], index, sc.attn,
                                   window=window)
    elif mode == "prefill":
        y, c = attn_lib.gqa_fwd(p["mix"], h, pos, sc.attn, window=window,
                                return_cache=True, segments=segments)
    elif mode == "train":
        y = attn_lib.gqa_fwd(p["mix"], h, pos, sc.attn, window=window,
                             segments=segments)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + y
    if bd.ffn != "none":
        x = x + ffn_apply(p["ffn"], rmsnorm(p["norm2"], x, sc.norm_eps),
                          sc.act)
    return x, (None if c is None else {"mix": c})


# ---------------------------------------------------------------- stack ----
def stack_init(gen, sc: StackConfig, device="cpu"):
    params = {}
    for si, (defs, n) in enumerate(sc.segments):
        params[f"seg{si}"] = _stacked(
            lambda g: {f"b{i}": block_init(g, bd, sc, device)
                       for i, bd in enumerate(defs)}, gen, n)
    return params


def stack_init_cache(sc: StackConfig, batch: int, length: int,
                     dtype=torch.bfloat16, device="cpu"):
    """Stacked (per-segment) decode caches, (layers, B, ...) leaves."""
    caches = {}
    for si, (defs, n) in enumerate(sc.segments):
        group = {f"b{i}": block_init_cache(bd, sc, batch, length, dtype,
                                           device)
                 for i, bd in enumerate(defs)}
        caches[f"seg{si}"] = tu.tree_map(
            lambda x: x[None].expand((n,) + tuple(x.shape)).clone(), group)
    return caches


def _layers(tree, n: int):
    """The ``n`` per-layer views of a stacked tree, from one
    ``torch.unbind`` per leaf: its backward stacks the layers' gradients
    once, where indexing ``x[i]`` would add a zero tensor the size of the
    whole stack per layer."""
    leaves, treedef = tu.flatten(tree)
    cols = [torch.unbind(l) for l in leaves]
    return [tu.unflatten(treedef, [c[i] for c in cols]) for i in range(n)]


def _apply_qdq(gp, codes, qdq_fn, defs):
    """One stacked layer's weights through ``qdq_fn``, each block's at its
    own code (a device tensor: no host read)."""
    if qdq_fn is None:
        return gp
    return {f"b{i}": tu.tree_map(lambda w, c=codes[i]: qdq_fn(w, c),
                                 gp[f"b{i}"])
            for i in range(len(defs))}


def _train_layer(gpi, x, pos, defs, sc: StackConfig, segments, codes=None,
                 qdq_fn=None):
    gpi = _apply_qdq(gpi, codes, qdq_fn, defs)
    for i, bd in enumerate(defs):
        x, _ = _block_fwd(gpi[f"b{i}"], x, pos, bd, sc, "train",
                          segments=segments)
    return x


def _aux_zeros(device):
    """The MoE aux terms (no MoE block is ported: both are zero)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"moe_load_balance": z, "moe_z_loss": z.clone()}


def stack_fwd(params, x, pos, sc: StackConfig, mode: str = "train",
              caches=None, index=None, codes=None, qdq_fn=None,
              segments=None):
    """Run the stack -> (x, caches, aux). Train mode returns no caches and
    the zero MoE aux terms; prefill returns fresh stacked caches (layers,
    B, S, ...); decode updates ``caches`` in place and returns them.
    ``codes`` ((num_layers,) int32, train mode only) are the layers'
    precision codes for ``qdq_fn``, the in-loss precision emulation;
    without ``codes`` every layer takes tier 1 (bf16)."""
    if mode == "train":
        flags = attn_lib.dispatch_flags()
        ctx = lambda: (contextlib.nullcontext(),           # noqa: E731
                       attn_lib.dispatch_context(flags))
        layer0 = 0
        for si, (defs, n) in enumerate(sc.segments):
            k = len(defs)
            seg_codes = [None] * n
            if qdq_fn is not None:
                seg_codes = (codes[layer0:layer0 + n * k].reshape(n, k)
                             if codes is not None else
                             torch.ones((n, k), dtype=torch.int32,
                                        device=x.device)).unbind(0)
            layer0 += n * k
            for gpi, ci in zip(_layers(params[f"seg{si}"], n), seg_codes):
                if sc.remat:
                    x = checkpoint(_train_layer, gpi, x, pos, defs, sc,
                                   segments, ci, qdq_fn, use_reentrant=False,
                                   context_fn=ctx, preserve_rng_state=False)
                else:
                    x = _train_layer(gpi, x, pos, defs, sc, segments, ci,
                                     qdq_fn)
        return x, None, _aux_zeros(x.device)
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    new_caches = {}
    for si, (defs, n) in enumerate(sc.segments):
        gp = params[f"seg{si}"]
        per_layer = []
        layer_caches = (_layers(caches[f"seg{si}"], n) if mode == "decode"
                        else [None] * n)
        for gpi, ci in zip(_layers(gp, n), layer_caches):
            cs = {}
            for i, bd in enumerate(defs):
                x, cs[f"b{i}"] = _block_fwd(
                    gpi[f"b{i}"], x, pos, bd, sc, mode,
                    cache=ci[f"b{i}"] if ci is not None else None,
                    index=index, segments=segments)
            per_layer.append(cs)
        if mode == "prefill":
            new_caches[f"seg{si}"] = tu.tree_map(
                lambda *xs: torch.stack(xs), *per_layer)
        else:
            new_caches[f"seg{si}"] = caches[f"seg{si}"]
    return x, new_caches, None
