"""Block and stack composition, as ``repro/nn/blocks.py``.

A trunk is a sequence of *segments*, each a group of blocks repeated N
times. Parameters of a segment are stacked with a leading layer axis (the
reference's ``lax.scan`` layout, so weights cross unchanged); the port
walks that axis with a Python loop. Caches are stacked the same way,
(layers, B, ...), and updated in place by decode.

Ported so far: ``gqa`` and ``mla`` attention, ``ssd`` (Mamba-2) and
``rglru`` (Griffin) mixing, with the dense FFN, the MoE FFN or none, in
the ``train``, ``prefill`` and ``decode`` modes. In train mode each
layer runs under ``torch.utils.checkpoint`` when ``remat`` (the
reference's ``jax.checkpoint``), so backward recomputes it; the in-loss
precision emulation (``codes``/``qdq_fn`` of ``reference_step``) rounds
each layer's weights inside that checkpoint. The MoE aux terms are summed
over the layers in train mode, through the checkpoints. The recurrent
blocks' decode caches are state rows (f32, no sequence axis) that decode
overwrites in place. Cross-attention blocks wait for their slice.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tu
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import rglru as rglru_lib
from repro_torch.nn import ssm as ssm_lib
from repro_torch.nn.attention import AttnConfig, MLAConfig
from repro_torch.nn.layers import (activation, dense, dense_init, rmsnorm,
                                   rmsnorm_init)
from repro_torch.nn.module import stack_init as _stacked
from repro_torch.nn.moe import MoEConfig
from repro_torch.nn.rglru import RGLRUConfig
from repro_torch.nn.ssm import SSMConfig


@dataclasses.dataclass(frozen=True)
class BlockDef:
    kind: str                 # "gqa" | "mla" | "ssd" | "rglru"
    ffn: str = "dense"        # "dense" | "moe" | "none"
    window: int = 0           # 0 = global attention; > 0 = sliding window
    cross: bool = False       # decoder block with cross-attention


@dataclasses.dataclass(frozen=True)
class StackConfig:
    segments: Tuple[Tuple[Tuple[BlockDef, ...], int], ...]
    d_model: int
    d_ff: int
    attn: Optional[AttnConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    moe: Optional[MoEConfig] = None
    act: str = "silu"
    gated: bool = True        # SwiGLU-style gated FFN vs plain 2-matrix MLP
    norm_eps: float = 1e-6
    remat: bool = True

    @property
    def num_layers(self) -> int:
        return sum(len(defs) * n for defs, n in self.segments)


#: the mixing kinds -> (their init, their StackConfig field)
_MIX_INIT = {"gqa": (attn_lib.gqa_init, "attn"),
             "mla": (attn_lib.mla_init, "mla"),
             "ssd": (ssm_lib.ssm_init, "ssm"),
             "rglru": (rglru_lib.rglru_init, "rglru")}
#: the recurrent kinds -> (sequence forward, one-step decode, their
#: StackConfig field)
_RECURRENT = {"ssd": (ssm_lib.ssm_fwd, ssm_lib.ssm_decode, "ssm"),
              "rglru": (rglru_lib.rglru_fwd, rglru_lib.rglru_decode,
                        "rglru")}


def _check_block(bd: BlockDef) -> None:
    if bd.kind not in _MIX_INIT or bd.ffn not in ("dense", "moe", "none") \
            or bd.cross:
        raise NotImplementedError(
            f"block {bd} is not ported yet: the port runs gqa, mla, ssd and "
            "rglru blocks with dense, MoE or no FFNs (cross-attention comes "
            "with the encoder-decoder slice)")


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
    p: Dict[str, Any] = {"norm1": rmsnorm_init(gen, sc.d_model, device)}
    init, field = _MIX_INIT[bd.kind]
    p["mix"] = init(gen, getattr(sc, field), device)
    if bd.ffn != "none":
        p["norm2"] = rmsnorm_init(gen, sc.d_model, device)
        p["ffn"] = (moe_lib.moe_init(gen, sc.moe, device) if bd.ffn == "moe"
                    else ffn_init(gen, sc.d_model, sc.d_ff, sc.gated,
                                  device))
    return p


def block_init_cache(bd: BlockDef, sc: StackConfig, batch: int, length: int,
                     dtype=torch.bfloat16, device="cpu"):
    """Decode-time cache for one block."""
    _check_block(bd)
    if bd.kind == "mla":
        return {"mix": attn_lib.mla_init_cache(sc.mla, batch, length, dtype,
                                               device)}
    if bd.kind == "ssd":
        return {"mix": ssm_lib.ssm_init_cache(sc.ssm, batch, device)}
    if bd.kind == "rglru":
        return {"mix": rglru_lib.rglru_init_cache(sc.rglru, batch, device)}
    L = min(length, bd.window) if bd.window > 0 else length
    return {"mix": attn_lib.gqa_init_cache(sc.attn, batch, L, dtype,
                                           device)}


def _block_fwd(p, x, pos, bd: BlockDef, sc: StackConfig, mode: str,
               cache=None, index=None, segments=None):
    """-> (x, new_cache, aux) for one block in {train, prefill, decode};
    the cache is None in train mode, ``aux`` the MoE block's aux terms
    (None for a block without a MoE FFN, whose terms are zero)."""
    _check_block(bd)
    h = rmsnorm(p["norm1"], x, sc.norm_eps)
    window = bd.window or None
    c = None
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if bd.kind in _RECURRENT:
        fwd, dec, field = _RECURRENT[bd.kind]
        cfg = getattr(sc, field)
        if mode == "decode":
            y, c = dec(p["mix"], h, cache["mix"], cfg)
        elif mode == "prefill":
            y, c = fwd(p["mix"], h, cfg, return_cache=True)
        else:
            y = fwd(p["mix"], h, cfg)
    elif bd.kind == "mla":
        if mode == "decode":
            y, c = attn_lib.mla_decode(p["mix"], h, cache["mix"], index,
                                       sc.mla)
        elif mode == "prefill":
            y, c = attn_lib.mla_fwd(p["mix"], h, pos, sc.mla,
                                    return_cache=True, segments=segments)
        else:
            y = attn_lib.mla_fwd(p["mix"], h, pos, sc.mla, segments=segments)
    elif mode == "decode":
        y, c = attn_lib.gqa_decode(p["mix"], h, cache["mix"], index, sc.attn,
                                   window=window)
    elif mode == "prefill":
        y, c = attn_lib.gqa_fwd(p["mix"], h, pos, sc.attn, window=window,
                                return_cache=True, segments=segments)
    else:
        y = attn_lib.gqa_fwd(p["mix"], h, pos, sc.attn, window=window,
                             segments=segments)
    x = x + y
    aux = None
    if bd.ffn != "none":
        h2 = rmsnorm(p["norm2"], x, sc.norm_eps)
        if bd.ffn == "moe":
            y2, aux = moe_lib.moe_apply(p["ffn"], h2, sc.moe)
        else:
            y2 = ffn_apply(p["ffn"], h2, sc.act)
        x = x + y2
    return x, (None if c is None else {"mix": c}), aux


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


def _train_layer(gpi, x, lb, zl, pos, defs, sc: StackConfig, segments,
                 codes=None, qdq_fn=None):
    """One stacked layer in train mode -> (x, lb, zl): the running sums of
    the MoE aux terms carried through it, as the reference's scan carry,
    so they pass through the layer's checkpoint."""
    gpi = _apply_qdq(gpi, codes, qdq_fn, defs)
    for i, bd in enumerate(defs):
        x, _, ai = _block_fwd(gpi[f"b{i}"], x, pos, bd, sc, "train",
                              segments=segments)
        if ai is not None:
            lb = lb + ai["moe_load_balance"]
            zl = zl + ai["moe_z_loss"]
    return x, lb, zl


def _aux_zeros(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"moe_load_balance": z, "moe_z_loss": z.clone()}


def stack_fwd(params, x, pos, sc: StackConfig, mode: str = "train",
              caches=None, index=None, codes=None, qdq_fn=None,
              segments=None):
    """Run the stack -> (x, caches, aux). Train mode returns no caches and
    the MoE aux terms summed over the layers; prefill returns fresh stacked
    caches (layers, B, S, ...); decode updates ``caches`` in place and
    returns them. Prefill and decode return the aux terms of the
    reference's loop (the initial zeros), unused there.
    ``codes`` ((num_layers,) int32, train mode only) are the layers'
    precision codes for ``qdq_fn``, the in-loss precision emulation;
    without ``codes`` every layer takes tier 1 (bf16)."""
    aux = _aux_zeros(x.device)
    if mode == "train":
        lb, zl = aux["moe_load_balance"], aux["moe_z_loss"]
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
                    x, lb, zl = checkpoint(
                        _train_layer, gpi, x, lb, zl, pos, defs, sc,
                        segments, ci, qdq_fn, use_reentrant=False,
                        context_fn=ctx, preserve_rng_state=False)
                else:
                    x, lb, zl = _train_layer(gpi, x, lb, zl, pos, defs, sc,
                                             segments, ci, qdq_fn)
        return x, None, {"moe_load_balance": lb, "moe_z_loss": zl}
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
                x, cs[f"b{i}"], _ = _block_fwd(
                    gpi[f"b{i}"], x, pos, bd, sc, mode,
                    cache=ci[f"b{i}"] if ci is not None else None,
                    index=index, segments=segments)
            per_layer.append(cs)
        if mode == "prefill":
            new_caches[f"seg{si}"] = tu.tree_map(
                lambda *xs: torch.stack(xs), *per_layer)
        else:
            new_caches[f"seg{si}"] = caches[f"seg{si}"]
    return x, new_caches, aux
