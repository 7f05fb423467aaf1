"""Attention: grouped-query attention (GQA) with rotary embeddings and
sliding windows, over three execution paths, as ``repro/nn/attention.py``:

  * ``naive``   — materializes (Sq, Sk) scores; the reference and decode
                  fallback;
  * ``chunked`` — online softmax over (q, k) chunks, O(chunk^2) score
                  memory; the fallback where the kernel gate fails;
  * ``flash``   — the hand-written kernels through
                  ``kernels.ops.flash_attention``: the forward, and with
                  grad the backward kernels too (plain versions on the
                  CPU).

GQA decode over an unwindowed full-length cache goes through the ragged
decode kernel (``kernels.ops.flash_decode``): row b reads its live
``index[b] + 1`` slots, not the cache's capacity. Caches are updated in
place (the reference's are donated): ``gqa_decode`` writes the new K/V row
into the cache tensors it is given and returns the same dict.

Multi-head latent attention (MLA, DeepSeek-V2) trains and prefills through
``attention`` at its split head dims (q and k nope + rope, v its own) and
decodes in the reference's absorbed form against its compressed cache
(``ckv``, ``kr``), updated in place as GQA's. Cross-attention waits for
the encoder-decoder slice.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Tuple

import torch

from repro_torch.nn.layers import (apply_rope, dense, dense_init, rmsnorm,
                                   rmsnorm_init)
from repro_torch.nn.module import param

NEG_INF = -2.0e38

# The flash kernel hard-codes the standard arange mask, so its dispatcher
# must know that positions are standard. The call site that BUILDS the
# positions from an arange declares it here, as the reference does.
_STD_POS = threading.local()
_SEG_POS = threading.local()


@contextlib.contextmanager
def std_positions(flag: bool = True):
    """Declare that positions flowing into ``attention()`` below are the
    standard broadcast arange (train / prefill with no packed batch)."""
    prev = getattr(_STD_POS, "flag", False)
    _STD_POS.flag = bool(flag)
    try:
        yield
    finally:
        _STD_POS.flag = prev


@contextlib.contextmanager
def segment_positions(flag: bool = True):
    """Declare that positions flowing into ``attention()`` below are the
    within-segment arange of the ``segments`` passed alongside them."""
    prev = getattr(_SEG_POS, "flag", False)
    _SEG_POS.flag = bool(flag)
    try:
        yield
    finally:
        _SEG_POS.flag = prev


def dispatch_flags():
    """The calling thread's attention dispatch declarations: (standard
    positions, segment positions, ``kernels.ops.flash_fallback``). A layer
    recomputed in backward runs on autograd's thread, where the flags are
    unset; ``dispatch_context`` restores them there."""
    from repro_torch.kernels import ops
    return (getattr(_STD_POS, "flag", False),
            getattr(_SEG_POS, "flag", False), ops.fallback_forced())


class dispatch_context:
    """Enter the declarations ``dispatch_flags()`` captured. Re-entrant: a
    checkpoint's recompute context is entered once for each recompute, and
    a double backward (the §3.2 HVP) recomputes a layer twice."""

    def __init__(self, flags):
        self.flags = flags
        self._open: list = []

    def __enter__(self):
        from repro_torch.kernels import ops
        std, seg, forced = self.flags
        stack = contextlib.ExitStack()
        stack.enter_context(std_positions(std))
        stack.enter_context(segment_positions(seg))
        stack.enter_context(ops.flash_fallback(forced))
        self._open.append(stack)

    def __exit__(self, *exc):
        return self._open.pop().__exit__(*exc)


def packed_positions(segments: torch.Tensor) -> torch.Tensor:
    """Within-segment arange for a packed batch: (B, S) non-decreasing
    document ids -> positions restarting at 0 on every boundary."""
    B, S = segments.shape
    idx = torch.arange(S, dtype=torch.int32,
                       device=segments.device)[None].expand(B, S)
    start = torch.ones((B, S), dtype=torch.bool, device=segments.device)
    start[:, 1:] = segments[:, 1:] != segments[:, :-1]
    first = torch.cummax(torch.where(start, idx, 0), dim=1).values
    return (idx - first).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, ...]] = None
    qk_norm: bool = False
    causal: bool = True
    impl: str = "chunked"          # "naive" | "chunked" | "flash"
    q_chunk: int = 512
    k_chunk: int = 512
    softmax_scale: Optional[float] = None

    @property
    def scale(self) -> float:
        return (self.softmax_scale if self.softmax_scale is not None
                else self.head_dim ** -0.5)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2): q directly or through a
    low-rank ``q_lora_rank`` bottleneck, k/v from a ``kv_lora_rank``
    compressed row plus a shared rotary key part."""
    d_model: int
    num_heads: int
    q_lora_rank: Optional[int]     # None -> direct q projection (v2-lite)
    kv_lora_rank: int
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    impl: str = "chunked"
    q_chunk: int = 512
    k_chunk: int = 512

    @property
    def scale(self) -> float:
        return (self.qk_nope_dim + self.qk_rope_dim) ** -0.5


# =========================================================== mask helpers ==
def decode_index(index, batch: int, device=None) -> torch.Tensor:
    """A decode index (scalar or (B,)) -> per-request positions (B,)
    int32."""
    idx = torch.as_tensor(index, dtype=torch.int32, device=device)
    return idx.expand(batch) if idx.dim() == 0 else idx.reshape(batch)


def _mask_bias(q_pos, k_pos, causal: bool, window, q_seg=None, k_seg=None):
    """Additive bias (0 / NEG_INF): (B, Sq), (B, Sk) -> (B, Sq, Sk) f32.
    Cache slots with position < 0 are empty (always masked)."""
    d = q_pos[:, :, None].long() - k_pos[:, None, :].long()
    ok = (k_pos[:, None, :] >= 0).expand(d.shape)
    if causal:
        ok = ok & (d >= 0)
    if window is not None:
        w = int(window)
        if w > 0:
            ok = ok & (d < w)
    if q_seg is not None:
        ok = ok & (q_seg[:, :, None] == k_seg[:, None, :])
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(ok, zero, NEG_INF)


# ======================================================= core attention ====
def _naive_attention(q, k, v, q_pos, k_pos, causal, window, scale,
                     q_seg=None, k_seg=None):
    """q (B, Sq, H, D); k (B, Sk, K, D); v (B, Sk, K, Dv) -> (B, Sq, H, Dv)."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    rep = H // K
    qr = q.reshape(B, Sq, K, rep, D).float() * scale
    scores = torch.einsum("bqkrd,bskd->bqkrs", qr, k.float())
    bias = _mask_bias(q_pos, k_pos, causal, window, q_seg, k_seg)
    scores = scores + bias[:, :, None, None, :]
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqkrs,bskd->bqkrd", p, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _chunked_attention(q, k, v, q_pos, k_pos, causal, window, scale,
                       q_chunk, k_chunk, q_seg=None, k_seg=None):
    """Online softmax over q chunks (outer) and k chunks (inner). With a
    static window in causal self-attention, each q chunk reads only the
    band of k chunks ending at its diagonal, as the reference does."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = H // K
    if Sq % q_chunk or Sk % k_chunk:
        raise ValueError(f"chunks ({q_chunk}, {k_chunk}) do not tile "
                         f"({Sq}, {Sk})")
    nq = Sq // q_chunk
    band = None
    if isinstance(window, int) and window > 0 and causal and Sq == Sk:
        band_len = -(-(window - 1 + q_chunk) // k_chunk) * k_chunk
        if band_len < Sk:
            band = band_len
    qr = q.reshape(B, Sq, K, rep, D).float() * scale
    kf, vf = k.float(), v.float()
    outs = []
    for qi in range(nq):
        qs = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qc, qp = qr[:, qs], q_pos[:, qs]
        qsg = q_seg[:, qs] if q_seg is not None else None
        if band is None:
            start, length = 0, Sk
        else:
            start = min(max(qi * q_chunk + q_chunk - band, 0), Sk - band)
            length = band
        acc = torch.zeros((B, q_chunk, K, rep, Dv), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, q_chunk, K, rep), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, q_chunk, K, rep), dtype=torch.float32,
                        device=q.device)
        for k0 in range(start, start + length, k_chunk):
            ks = slice(k0, k0 + k_chunk)
            s = torch.einsum("bqkrd,bskd->bqkrs", qc, kf[:, ks])
            ksg = k_seg[:, ks] if k_seg is not None else None
            s = s + _mask_bias(qp, k_pos[:, ks], causal, window, qsg,
                               ksg)[:, :, None, None, :]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bqkrs,bskd->bqkrd",
                                                       p, vf[:, ks])
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, Dv)
    return out.to(q.dtype)


def attention(q, k, v, q_pos, k_pos, *, causal, window, scale,
              impl="chunked", q_chunk=512, k_chunk=512, segments=None):
    if impl == "flash":
        # the kernel path; dropping the position arrays is sound only for
        # self-attention positions the constructor declared standard (or
        # the within-segment arange of ``segments``)
        from repro_torch.kernels import ops as kops
        hinted = q_pos is k_pos and (
            getattr(_SEG_POS, "flag", False) if segments is not None
            else getattr(_STD_POS, "flag", False))
        return kops.flash_attention(q, k, v,
                                    None if hinted else q_pos,
                                    None if hinted else k_pos,
                                    segments=segments, causal=causal,
                                    window=window, scale=scale)
    if (impl == "chunked" and q.shape[1] % q_chunk == 0
            and k.shape[1] % k_chunk == 0 and q.shape[1] >= q_chunk
            and k.shape[1] >= k_chunk):
        return _chunked_attention(q, k, v, q_pos, k_pos, causal, window,
                                  scale, q_chunk, k_chunk,
                                  q_seg=segments, k_seg=segments)
    return _naive_attention(q, k, v, q_pos, k_pos, causal, window, scale,
                            q_seg=segments, k_seg=segments)


# ================================================================= GQA ======
def _proj_init(gen, dm, heads, hd, device):
    return {"kernel": param(gen, (dm, heads, hd), "normal",
                            1.0 / math.sqrt(dm), device)}


def _out_init(gen, heads, hd, dm, device):
    return {"kernel": param(gen, (heads, hd, dm), "normal",
                            1.0 / math.sqrt(heads * hd), device)}


def proj(p, x):
    """(B, S, d) @ (d, H, D) -> (B, S, H, D)."""
    w = p["kernel"].to(x.dtype)
    return (x @ w.reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], w.shape[1], w.shape[2])


def out_proj(p, y):
    """(B, S, H, D) @ (H, D, d) -> (B, S, d)."""
    w = p["kernel"].to(y.dtype)
    return y.reshape(*y.shape[:-2], -1) @ w.reshape(-1, w.shape[-1])


def gqa_init(gen, cfg: AttnConfig, device="cpu"):
    H, K, D, dm = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    p = {"wq": _proj_init(gen, dm, H, D, device),
         "wk": _proj_init(gen, dm, K, D, device),
         "wv": _proj_init(gen, dm, K, D, device),
         "wo": _out_init(gen, H, D, dm, device)}
    if cfg.qk_norm:
        p["qnorm"] = rmsnorm_init(gen, D, device)
        p["knorm"] = rmsnorm_init(gen, D, device)
    return p


def _gqa_qkv(p, x, q_pos, cfg: AttnConfig, mrope_positions=None):
    if cfg.mrope_sections is not None and mrope_positions is not None:
        raise NotImplementedError("multimodal RoPE waits for the qwen2-vl "
                                  "slice of the port")
    q = proj(p["wq"], x)
    k = proj(p["wk"], x)
    v = proj(p["wv"], x)
    if cfg.qk_norm:
        q = rmsnorm(p["qnorm"], q)
        k = rmsnorm(p["knorm"], k)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, q_pos, cfg.rope_theta)
    return q, k, v


def gqa_fwd(p, x, q_pos, cfg: AttnConfig, window=None, mrope_positions=None,
            return_cache=False, segments=None):
    """Self-attention over a full sequence (prefill). x: (B, S, d_model);
    q_pos: (B, S) int32. With ``return_cache`` also the KV cache: the
    rope-applied keys, the values and the slot positions."""
    q, k, v = _gqa_qkv(p, x, q_pos, cfg, mrope_positions)
    out = attention(q, k, v, q_pos, q_pos, causal=cfg.causal, window=window,
                    scale=cfg.scale, impl=cfg.impl, q_chunk=cfg.q_chunk,
                    k_chunk=cfg.k_chunk, segments=segments)
    y = out_proj(p["wo"], out)
    if return_cache:
        return y, {"k": k, "v": v, "pos": q_pos}
    return y


def gqa_init_cache(cfg: AttnConfig, batch: int, length: int,
                   dtype=torch.bfloat16, device="cpu"):
    K, D = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, length, K, D), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, length, K, D), dtype=dtype,
                             device=device),
            "pos": torch.full((batch, length), -1, dtype=torch.int32,
                              device=device)}


def gqa_decode(p, x, cache, index, cfg: AttnConfig, window=None,
               mrope_positions=None):
    """One decode step. x: (B, 1, d_model); index: scalar or (B,) per-request
    positions. Writes the new K/V row at slot index % L of each row of
    ``cache`` IN PLACE (the cache ring-buffers when shorter than the
    context) and returns (y, cache)."""
    B = x.shape[0]
    L = cache["k"].shape[1]
    idx = decode_index(index, B, x.device)
    pos = idx[:, None]
    q, k_new, v_new = _gqa_qkv(p, x, pos, cfg, mrope_positions)
    slot = (idx % L).long()
    rows = torch.arange(B, device=x.device)
    k, v, cpos = cache["k"], cache["v"], cache["pos"]
    k[rows, slot] = k_new[:, 0].to(k.dtype)
    v[rows, slot] = v_new[:, 0].to(v.dtype)
    cpos[rows, slot] = pos[:, 0]
    from repro_torch.kernels import ops as kops
    if cfg.impl == "flash" and kops.flash_decode_gate(q.shape, k.shape,
                                                      window):
        # a full-length unwindowed cache holds slots [0, idx] of row b, so
        # the kernel's loop stops at idx + 1: reads scale with the live
        # length, not the capacity
        lengths = torch.clamp_max(idx + 1, L)
        out = kops.flash_decode(q, k, v, lengths, scale=cfg.scale)
    else:
        out = _naive_attention(q, k, v, pos, cpos, causal=True,
                               window=window, scale=cfg.scale)
    y = out_proj(p["wo"], out)
    return y, cache


# ================================================================= MLA ======
def mla_init(gen, cfg: MLAConfig, device="cpu"):
    dm, H = cfg.d_model, cfg.num_heads
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    p = {}
    if cfg.q_lora_rank:
        p["wdq"] = dense_init(gen, dm, cfg.q_lora_rank, device=device)
        p["qnorm"] = rmsnorm_init(gen, cfg.q_lora_rank, device)
        p["wuq"] = _proj_init(gen, cfg.q_lora_rank, H, qk_dim, device)
    else:
        p["wq"] = _proj_init(gen, dm, H, qk_dim, device)
    p["wdkv"] = dense_init(gen, dm, cfg.kv_lora_rank, device=device)
    p["kvnorm"] = rmsnorm_init(gen, cfg.kv_lora_rank, device)
    p["wkr"] = dense_init(gen, dm, cfg.qk_rope_dim, device=device)
    p["wuk"] = _proj_init(gen, cfg.kv_lora_rank, H, cfg.qk_nope_dim, device)
    p["wuv"] = _proj_init(gen, cfg.kv_lora_rank, H, cfg.v_head_dim, device)
    p["wo"] = _out_init(gen, H, cfg.v_head_dim, dm, device)
    return p


def _mla_q(p, x, q_pos, cfg: MLAConfig):
    """-> (q_nope, q_rope), (B, S, H, nope) and (B, S, H, rope); the q-lora
    form (``wdq`` -> ``qnorm`` -> ``wuq``) where the config has a rank."""
    if cfg.q_lora_rank:
        q = proj(p["wuq"], rmsnorm(p["qnorm"], dense(p["wdq"], x)))
    else:
        q = proj(p["wq"], x)
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    return q_nope, apply_rope(q_rope, q_pos, cfg.rope_theta)


def _mla_ckv(p, x, pos, cfg: MLAConfig):
    """-> (ckv (B, S, rank), kr (B, S, rope)): the compressed cache rows."""
    ckv = rmsnorm(p["kvnorm"], dense(p["wdkv"], x))
    kr = apply_rope(dense(p["wkr"], x)[:, :, None, :], pos,
                    cfg.rope_theta)[:, :, 0, :]
    return ckv, kr


def mla_fwd(p, x, q_pos, cfg: MLAConfig, window=None, return_cache=False,
            segments=None):
    """Training / prefill MLA: the compressed kv expanded into per-head k
    (nope, then the shared rope part broadcast over the heads) and v, then
    ``attention`` at the split head dims (q and k nope + rope, v
    ``v_head_dim``). ``torch.cat`` writes k whole, so the kernels get
    contiguous operands. With ``return_cache`` also the compressed cache:
    ``ckv``, ``kr`` and the positions."""
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope = _mla_q(p, x, q_pos, cfg)
    ckv, kr = _mla_ckv(p, x, q_pos, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([proj(p["wuk"], ckv),
                   kr[:, :, None, :].expand(B, S, H, cfg.qk_rope_dim)],
                  dim=-1)
    v = proj(p["wuv"], ckv)
    out = attention(q, k, v, q_pos, q_pos, causal=True, window=window,
                    scale=cfg.scale, impl=cfg.impl, q_chunk=cfg.q_chunk,
                    k_chunk=cfg.k_chunk, segments=segments)
    y = out_proj(p["wo"], out)
    if return_cache:
        return y, {"ckv": ckv, "kr": kr, "pos": q_pos}
    return y


def mla_init_cache(cfg: MLAConfig, batch: int, length: int,
                   dtype=torch.bfloat16, device="cpu"):
    return {"ckv": torch.zeros((batch, length, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros((batch, length, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
            "pos": torch.full((batch, length), -1, dtype=torch.int32,
                              device=device)}


def mla_decode(p, x, cache, index, cfg: MLAConfig):
    """One absorbed-matmul MLA decode step against the compressed cache,
    in f32 as the reference: ``W_uk`` folds into the query (q_abs = q_nope
    W_uk per head), the scores are taken against ``ckv`` plus q_rope
    against ``kr``, and ``W_uv`` applies after the weighted sum, so no
    per-head K or V is made. Writes the new row at slot index % L of each
    row of ``cache`` IN PLACE and returns (y, cache)."""
    B = x.shape[0]
    L = cache["ckv"].shape[1]
    idx = decode_index(index, B, x.device)
    pos = idx[:, None]
    q_nope, q_rope = _mla_q(p, x, pos, cfg)               # (B, 1, H, .)
    ckv_new, kr_new = _mla_ckv(p, x, pos, cfg)
    slot = (idx % L).long()
    rows = torch.arange(B, device=x.device)
    ckv, kr, cpos = cache["ckv"], cache["kr"], cache["pos"]
    ckv[rows, slot] = ckv_new[:, 0].to(ckv.dtype)
    kr[rows, slot] = kr_new[:, 0].to(kr.dtype)
    cpos[rows, slot] = pos[:, 0]
    ckv_f = ckv.float()
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope.float(),
                         p["wuk"]["kernel"].float())      # (B, 1, H, R)
    s = (torch.einsum("bqhr,bsr->bhqs", q_abs, ckv_f)
         + torch.einsum("bqhe,bse->bhqs", q_rope.float(), kr.float())
         ) * cfg.scale                                    # (B, H, 1, L)
    s = s + _mask_bias(pos, cpos, True, None)[:, None, :, :]
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", w, ckv_f)
    out = torch.einsum("bqhr,rhv->bqhv", ctx, p["wuv"]["kernel"].float())
    return out_proj(p["wo"], out.to(x.dtype)), cache


# ======================================================= not ported yet =====
def _not_ported(name: str, slice_: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} comes with {slice_} of the port")
    fn.__name__ = name
    return fn


cross_init = _not_ported("cross_init", "the encoder-decoder slice")
cross_make_cache = _not_ported("cross_make_cache",
                               "the encoder-decoder slice")
cross_fwd = _not_ported("cross_fwd", "the encoder-decoder slice")
