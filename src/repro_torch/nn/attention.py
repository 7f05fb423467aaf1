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

MLA and cross-attention wait for the architectures that use them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Tuple

import torch

from repro_torch.nn.layers import apply_rope, rmsnorm, rmsnorm_init
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


@contextlib.contextmanager
def dispatch_context(flags):
    """Enter the declarations ``dispatch_flags()`` captured."""
    from repro_torch.kernels import ops
    std, seg, forced = flags
    with std_positions(std), segment_positions(seg), \
            ops.flash_fallback(forced):
        yield


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


# ======================================================= not ported yet =====
def _not_ported(name: str, slice_: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} comes with {slice_} of the port")
    fn.__name__ = name
    return fn


mla_init = _not_ported("mla_init", "the MLA/MoE slice")
mla_fwd = _not_ported("mla_fwd", "the MLA/MoE slice")
mla_init_cache = _not_ported("mla_init_cache", "the MLA/MoE slice")
mla_decode = _not_ported("mla_decode", "the MLA/MoE slice")
cross_init = _not_ported("cross_init", "the encoder-decoder slice")
cross_make_cache = _not_ported("cross_make_cache",
                               "the encoder-decoder slice")
cross_fwd = _not_ported("cross_fwd", "the encoder-decoder slice")
