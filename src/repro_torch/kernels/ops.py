"""Public wrappers for the hand-written kernels, with the reference's
dispatch gates (``repro/kernels/ops.py``).

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor goes to the hand-written CUDA kernel, or the call raises. Nothing
falls back on a missing card. Each wrapper counts its kernel launches in
``LAUNCHES`` (a plain integer per kernel, bumped only where the kernel is
launched), so a run can show that the main path went through the kernels.
``qdq_cast`` also counts by form (``qdq_cast_two_pass``,
``qdq_cast_one_pass``: ``qdq_cast.form``) beside its total. The flash
forward counts by route (``flash_attention_tc``,
``flash_attention_simt``: ``flash_attention.fwd_route``) beside its total,
and so do the backward's dQ and dK/dV (``flash_attention_bwd_dq_tc`` /
``_tf32`` / ``_simt``, ``flash_attention_bwd_dkv_tc`` / ``_tf32`` /
``_simt``: ``flash_attention.bwd_route``).

The attention gates are the reference's, constants included (``BQ = BK =
256``, ``DECODE_BLOCKS``): where a gate fails, the call runs the chunked or
naive attention of ``nn.attention`` with the reference's one-time warning,
as the reference does.

``flash_attention`` is differentiable: where grad is on and an input needs
it, the kernel path is a ``torch.autograd.Function`` whose forward runs the
forward kernel with the LSE residual and whose backward runs the three
backward kernels (delta, dQ, dK/dV), as the reference's ``custom_vjp``.
``flash_fallback()`` pins the call to the chunked/naive paths, which torch
differentiates itself.
"""
from __future__ import annotations

import contextlib
import operator
import threading
import warnings

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import grad_stats as _gs
from repro_torch.kernels import qdq_cast as _qc

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = {"fused_stats": 0, "fused_apply": 0, "qdq_cast": 0,
            "qdq_cast_two_pass": 0, "qdq_cast_one_pass": 0,
            "grad_stats": 0, "flash_attention": 0,
            "flash_attention_tc": 0, "flash_attention_simt": 0,
            "flash_attention_bwd_delta": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq_tc": 0, "flash_attention_bwd_dq_tf32": 0,
            "flash_attention_bwd_dq_simt": 0,
            "flash_attention_bwd_dkv_tc": 0,
            "flash_attention_bwd_dkv_tf32": 0,
            "flash_attention_bwd_dkv_simt": 0,
            "flash_decode": 0}
#: fallback reasons already warned about (one warning per reason)
WARNED_FALLBACKS: set = set()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused_stats(g_slab, row_layer, num_layers: int):
    """Phase 1 of the fused update: one gradient read -> per-layer
    (sum, sum_sq, absmax, nonfinite_count)."""
    if g_slab.device.type == "cpu":
        return _fu.fused_stats_ref(g_slab, row_layer, num_layers)
    out = _fu.fused_stats_cuda(g_slab, row_layer, num_layers)
    LAUNCHES["fused_stats"] += 1
    return out


def fused_apply(g_slab, p_slab, m_slab, v_slab, scalars, row_layer,
                lr_rows, code_rows, qs_rows, *, spec, ladder, cp_dtype,
                num_layers, sr: bool = False):
    """Phase 2 of the fused update: final gradient read -> optimizer step,
    f32 master write, next-step compute copy (``sr=True`` casts it with
    stochastic rounding, seeded from ``scalars[4]``), per-layer param
    absmax."""
    kw = dict(spec=spec, ladder=ladder, cp_dtype=cp_dtype,
              num_layers=num_layers, sr=sr)
    args = (g_slab, p_slab, m_slab, v_slab, scalars, row_layer, lr_rows,
            code_rows, qs_rows)
    if p_slab.device.type == "cpu":
        return _fu.fused_apply_ref(*args, **kw)
    out = _fu.fused_apply_cuda(*args, **kw)
    LAUNCHES["fused_apply"] += 1
    return out


def qdq_cast(x, code, ladder: str = "tpu", amax=None, *, out_dtype=None):
    """Round ``x`` (any shape, f32 or bf16) to the tier grid ``code``
    picks; ``amax`` replaces the tensor's own absmax (tpu ladder). The
    result is written as ``out_dtype`` (default: ``x``'s type)."""
    if x.device.type == "cpu":
        return _qc.qdq_cast_ref(x, code, ladder, amax, out_dtype=out_dtype)
    out = _qc.qdq_cast_cuda(x, code, ladder, amax, out_dtype=out_dtype)
    if x.numel():                   # an empty tensor launches nothing
        LAUNCHES["qdq_cast"] += 1
        LAUNCHES[f"qdq_cast_{_qc.form(code, ladder, amax)}"] += 1
    return out


def grad_stats(x):
    """(sum, sum_sq, absmax) of all elements of ``x`` (any shape, f32, bf16
    or f16) as three 0-d f32 tensors, accumulated in f32."""
    if x.device.type == "cpu":
        return _gs.grad_stats_ref(x)
    out = _gs.grad_stats_cuda(x)
    LAUNCHES["grad_stats"] += 1
    return out


# ------------------------------------------------------------ dispatch -----
_FALLBACK = threading.local()


@contextlib.contextmanager
def flash_fallback(flag: bool = True):
    """Pin ``flash_attention`` below to the chunked/naive paths even where
    the kernel gate holds (no warning), for the calling thread. The
    reference pins its curvature probes there (forward-mode AD cannot
    cross its custom_vjp); the port's curvature loss does the same, so the
    probes launch no attention kernel."""
    prev = fallback_forced()
    _FALLBACK.flag = bool(flag)
    try:
        yield
    finally:
        _FALLBACK.flag = prev


def fallback_forced() -> bool:
    """Is ``flash_fallback`` in force on this thread?"""
    return getattr(_FALLBACK, "flag", False)


def _static_window(window):
    """Integral window -> python int (0 = unwindowed); None for a tensor
    window, which the kernel cannot specialize on."""
    if window is None:
        return 0
    if isinstance(window, torch.Tensor):
        return None
    try:
        return operator.index(window)
    except TypeError:
        return None


def _is_std_arange(pos, batch: int, seqlen: int) -> bool:
    """True when ``pos`` is None or a (B, S) tensor equal to the broadcast
    arange(S) (read on the host)."""
    if pos is None:
        return True
    if tuple(pos.shape) != (batch, seqlen):
        return False
    ar = torch.arange(seqlen, device=pos.device, dtype=pos.dtype)
    return bool((pos == ar[None]).all())


def kernel_shape_gate(q_shape, k_shape, v_shape) -> bool:
    """Static part of the dispatch gate: self-attention with Sq == Sk
    divisible by both block sizes and matching q/k head dims."""
    Sq, Sk = q_shape[1], k_shape[1]
    return (Sq == Sk and Sq % _fa.BQ == 0 and Sq % _fa.BK == 0
            and q_shape[-1] == k_shape[-1])


def kernel_fallback_reason(q_shape, k_shape, v_shape, q_pos, k_pos,
                           window, segments=None) -> str:
    """Why the kernel cannot take this call — "" when it can. The
    reference's taxonomy, reason strings included."""
    B, Sq = q_shape[0], q_shape[1]
    Sk = k_shape[1]
    if _static_window(window) is None:
        return "traced window (kernel specializes on a static window)"
    if Sq != Sk:
        return f"cross-length attention Sq={Sq} != Sk={Sk}"
    if Sq % _fa.BQ or Sq % _fa.BK:
        return (f"seq len {Sq} not divisible by kernel blocks "
                f"({_fa.BQ}/{_fa.BK})")
    if q_shape[-1] != k_shape[-1]:
        return f"q/k head dims differ ({q_shape[-1]} vs {k_shape[-1]})"
    if segments is not None:
        if q_pos is not None or k_pos is not None:
            return ("packed segments with undeclared positions (wrap the "
                    "constructor in nn.attention.segment_positions)")
        return ""
    if not (_is_std_arange(q_pos, B, Sq) and _is_std_arange(k_pos, B, Sk)):
        return ("positions not provably the standard arange (packed/offset "
                "batch without segment ids)")
    return ""


def _note_fallback(reason: str) -> None:
    """Warn once per fallback reason: the fallback paths are correct but
    pay full-window FLOPs."""
    if reason and reason not in WARNED_FALLBACKS:
        WARNED_FALLBACKS.add(reason)
        warnings.warn(
            f"flash_attention: kernel gate failed ({reason}); running the "
            "chunked/naive fallback", stacklevel=3)


def _flash_kernel(q, k, v, segments, causal, window, scale,
                  with_lse=False):
    if q.device.type == "cpu":
        return _fa.flash_attention_ref(q, k, v, segments, causal=causal,
                                       window=window, scale=scale,
                                       with_lse=with_lse)
    out = _fa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous(), segments, causal=causal,
                                   window=window, scale=scale,
                                   with_lse=with_lse)
    route = _fa.fwd_route(q.dtype, q.shape[-1], v.shape[-1])
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention_{route}"] += 1
    return out


def flash_bwd_delta(o, do):
    """delta (B, H, S) f32 = sum over Dv of dO * O."""
    if o.device.type == "cpu":
        return _fa.flash_bwd_delta_ref(o, do)
    out = _fa.flash_bwd_delta_cuda(o, do)
    LAUNCHES["flash_attention_bwd_delta"] += 1
    return out


def _count_bwd(name, q, v) -> None:
    route = _fa.bwd_route(q.dtype, q.shape[-1], v.shape[-1])
    LAUNCHES[name] += 1
    LAUNCHES[f"{name}_{route}"] += 1


def flash_bwd_dq(q, k, v, do, lse, delta, segments=None, *, causal=True,
                 window=0, scale=None):
    """dq (B, S, H, D) from the saved residuals, dO and delta."""
    kw = dict(causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        return _fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, segments, **kw)
    out = _fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, segments, **kw)
    _count_bwd("flash_attention_bwd_dq", q, v)
    return out


def flash_bwd_dkv(q, k, v, do, lse, delta, segments=None, *, causal=True,
                  window=0, scale=None):
    """(dk, dv), summed over the q heads of each kv head."""
    kw = dict(causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        return _fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, segments, **kw)
    out = _fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, segments, **kw)
    _count_bwd("flash_attention_bwd_dkv", q, v)
    return out


class _FlashAttention(torch.autograd.Function):
    """The kernel path as one differentiable op: forward kernel with the LSE
    residual, then delta, dQ and dK/dV kernels (plain versions on the CPU).
    ``segments`` gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segments, causal, window, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _flash_kernel(q, k, v, segments, causal, window, scale,
                               with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, segments)
        ctx.kw = dict(causal=causal, window=window, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segments = ctx.saved_tensors
        do = do.to(o.dtype).contiguous()
        delta = flash_bwd_delta(o, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, segments, **ctx.kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, segments, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, segments=None,
                    causal=True, window=None, scale=None):
    """Attention through the kernels where the reference's gate holds
    (self-attention, Sq == Sk divisible by 256, matching q/k head dims, a
    static window, positions None or the standard arange — or segments
    with positions declared segment-standard) and ``flash_fallback`` is
    off: the forward kernel alone, or with grad the differentiable op whose
    backward runs the backward kernels. The chunked or naive path of
    ``nn.attention`` elsewhere."""
    B, Sq = q.shape[0], q.shape[1]
    Sk = k.shape[1]
    win = _static_window(window)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    forced = fallback_forced()
    reason = kernel_fallback_reason(q.shape, k.shape, v.shape, q_pos, k_pos,
                                    window, segments)
    if not forced and not reason:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FlashAttention.apply(q, k, v, segments, bool(causal),
                                         win, float(scale))
        return _flash_kernel(q, k, v, segments, bool(causal), win,
                             float(scale))
    if not forced:
        _note_fallback(reason)
    from repro_torch.nn.attention import (_chunked_attention,
                                          _naive_attention)
    if win is not None:
        window = win if win > 0 else None
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(Sq, dtype=torch.int32,
                             device=dev)[None].expand(B, Sq)
    if k_pos is None:
        k_pos = torch.arange(Sk, dtype=torch.int32,
                             device=dev)[None].expand(B, Sk)
    if Sq % _fa.BQ == 0 and Sk % _fa.BK == 0:
        return _chunked_attention(q, k, v, q_pos, k_pos, causal, window,
                                  scale, _fa.BQ, _fa.BK,
                                  q_seg=segments, k_seg=segments)
    return _naive_attention(q, k, v, q_pos, k_pos, causal, window, scale,
                            q_seg=segments, k_seg=segments)


# --------------------------------------------------------- ragged decode --
def flash_decode_gate(q_shape, k_shape, window) -> bool:
    """Gate of the ragged decode kernel: a single-token query, an
    unwindowed full-length cache, matching q/k head dims, and a cache
    length the reference's decode blocks tile."""
    return (window is None and q_shape[1] == 1
            and q_shape[-1] == k_shape[-1]
            and _fa.decode_block(k_shape[1]) is not None)


def flash_decode(q, k, v, lengths, *, scale=None):
    """Row b of the (B, 1, H, D) query attends cache slots [0, lengths[b])
    only. Callers gate with ``flash_decode_gate``."""
    if q.device.type == "cpu":
        return _fa.flash_decode_ref(q, k, v, lengths, scale=scale)
    out = _fa.flash_decode_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), lengths, scale=scale)
    LAUNCHES["flash_decode"] += 1
    return out
