"""Flash attention: the prefill forward (causal, static window, optional
segments, optional LSE residual) and the ragged single-token decode.

Two forms of each: the hand-written CUDA kernels for Hopper
(``csrc/flash_attention.cu``, bound through ``ctypes``: ``*_cuda``) and
their plain PyTorch versions (``*_ref``), which mirror
``repro/kernels/ref.py`` (full softmax with the finite ``NEG_INF``).
``kernels.ops`` routes a CPU tensor to the plain version and a CUDA tensor
to the kernel, behind the reference's dispatch gates.

Shapes: q (B, S, H, D); k (B, S, K, D); v (B, S, K, Dv); H % K == 0 (GQA:
q head h reads kv head h // (H/K)). Decode: q (B, 1, H, D) against a
(B, L, K, D) / (B, L, K, Dv) cache; row b attends slots [0, lengths[b]).
A row of length 0 gives zeros, as the reference kernel's
``l = max(l, 1e-30)`` clamp gives (the reference's full-softmax oracle
would average V there; the kernels are what the JAX package runs).

``BQ``, ``BK`` and ``DECODE_BLOCKS`` are the reference's tile sizes. The
port keeps them for its gates, so it takes a kernel exactly where the
reference does; the CUDA kernels tile by 64 inside.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38
BQ = 256
BK = 256
#: candidate k-block sizes of the reference's ragged decode kernel; its gate
#: takes the kernel only where one of them tiles the cache length
DECODE_BLOCKS = (256, 128, 64, 32, 16, 8)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the CUDA forward's query tile (rows a block); S must be a multiple
CUDA_BQ = 64
MAX_HEAD_DIM = 256


def decode_block(L: int) -> Optional[int]:
    """The reference's k-block size for a cache of length ``L`` (None: no
    ragged kernel for this geometry). Prefers the largest block that still
    gives the ragged loop >= 4 steps."""
    largest = None
    for bd in DECODE_BLOCKS:
        if L % bd == 0:
            if largest is None:
                largest = bd
            if 4 * bd <= L:
                return bd
    return largest


# ================================================= plain versions =======
def flash_attention_ref(q, k, v, segments=None, *, causal: bool = True,
                        window: int = 0, scale: Optional[float] = None,
                        with_lse: bool = False):
    """Full-softmax attention -> o (B, S, H, Dv) in q's dtype, and with
    ``with_lse`` the (B, H, S) f32 logsumexp of each row's valid scores."""
    B, S, H, D = q.shape
    K = k.shape[2]
    Dv = v.shape[-1]
    rep = H // K
    if scale is None:
        scale = D ** -0.5
    qr = q.reshape(B, S, K, rep, D).float() * scale
    s = torch.einsum("bqkrd,bskd->bqkrs", qr, k.float())
    idx = torch.arange(S, device=q.device)
    d = idx[:, None] - idx[None, :]
    ok = torch.ones((B, S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (d >= 0)[None]
    if window and window > 0:
        ok = ok & (d < window)[None]
    if segments is not None:
        ok = ok & (segments[:, :, None] == segments[:, None, :])
    s = torch.where(ok[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkrs,bskd->bqkrd", p, v.float())
    out = out.reshape(B, S, H, Dv).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.logsumexp(s, dim=-1).reshape(B, S, H).permute(0, 2, 1)
    return out, lse.contiguous()


def flash_decode_ref(q, k, v, lengths, *, scale: Optional[float] = None):
    """Ragged decode: q (B, 1, H, D) attends slots [0, lengths[b]) of a
    (B, L, K, D) / (B, L, K, Dv) cache -> (B, 1, H, Dv); zeros where
    lengths[b] == 0."""
    B, _, H, D = q.shape
    L, K = k.shape[1], k.shape[2]
    rep = H // K
    if scale is None:
        scale = D ** -0.5
    qr = q.reshape(B, 1, K, rep, D).float() * scale
    s = torch.einsum("bqkrd,bskd->bqkrs", qr, k.float())
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    ok = torch.arange(L, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(ok[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkrs,bskd->bqkrd", p, v.float())
    out = torch.where((lengths > 0).reshape(B, 1, 1, 1, 1), out, 0.0)
    return out.reshape(B, 1, H, v.shape[-1]).to(q.dtype)


def tolerance(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per-element limit on |got - want| between a CUDA kernel and its plain
    version: 1e-5 of the tensor's largest magnitude plus 1e-5 relative
    (the sums run in another order, and the kernels contract a*b+c); in
    bf16 one ulp of the larger of the two on top (the f32 results round to
    neighbours at worst; near zero the f32 sums' cancellation error is many
    ulps of the tiny value, which the first term covers)."""
    g, w = got.float(), want.float()
    lim = 1e-5 * w.abs().max() + 1e-5 * w.abs()
    if got.dtype == torch.bfloat16:
        ax = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
        lim = lim + torch.exp2(torch.floor(torch.log2(ax)) - 7)
    return lim


# ================================================= CUDA kernels =========
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.tri_flash_fwd.argtypes is None:     # first use: declare the ABI
        lib.tri_flash_fwd.argtypes = [_P] * 6 + [_I] * 9 + [_F, _P]
        lib.tri_flash_fwd.restype = _I
        lib.tri_flash_decode.argtypes = [_P] * 5 + [_I] * 7 + [_F, _P]
        lib.tri_flash_decode.restype = _I
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _dims(q, k, v):
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q: dtype {q.dtype} not in {tuple(_DTYPE_CODE)}")
    B, S, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    if K < 1 or H % K:
        raise ValueError(f"q heads {H} not a multiple of kv heads {K}")
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims ({D}, {Dv}) above {MAX_HEAD_DIM}")
    return B, S, H, K, D, Dv


def flash_attention_cuda(q, k, v, segments=None, *, causal: bool = True,
                         window: int = 0, scale: Optional[float] = None,
                         with_lse: bool = False):
    """The forward kernel -> o (and the (B, H, S) f32 LSE with
    ``with_lse``); outputs are fresh tensors."""
    B, S, H, K, D, Dv = _dims(q, k, v)
    if S % CUDA_BQ:
        raise ValueError(f"seq len {S} not a multiple of {CUDA_BQ}")
    _check(q, "q", q.dtype, (B, S, H, D))
    _check(k, "k", q.dtype, (B, S, K, D))
    _check(v, "v", q.dtype, (B, S, K, Dv))
    dev = q.device
    seg = None
    if segments is not None:
        seg = segments.to(torch.int32).contiguous()
        _check(seg, "segments", torch.int32, (B, S))
    if k.device != dev or v.device != dev or (seg is not None
                                              and seg.device != dev):
        raise ValueError("flash_attention inputs lie on different devices")
    if scale is None:
        scale = D ** -0.5
    o = torch.empty((B, S, H, Dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if with_lse else None)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.tri_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg.data_ptr() if seg is not None else None, o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            _DTYPE_CODE[q.dtype], B, S, H, K, D, Dv, int(bool(causal)),
            int(window or 0), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention: CUDA launch failed with cudaError {rc}")
    return (o, lse) if with_lse else o


def flash_decode_cuda(q, k, v, lengths, *, scale: Optional[float] = None):
    """The ragged decode kernel -> (B, 1, H, Dv), a fresh tensor."""
    B, one, H, K, D, Dv = _dims(q, k, v)
    L = k.shape[1]
    if one != 1:
        raise ValueError(f"decode takes one query token, got {one}")
    if (H // K) * Dv > 2048:
        raise ValueError(f"(H/K) * Dv = {(H // K) * Dv} above 2048")
    _check(q, "q", q.dtype, (B, 1, H, D))
    _check(k, "k", q.dtype, (B, L, K, D))
    _check(v, "v", q.dtype, (B, L, K, Dv))
    lens = lengths.to(torch.int32).contiguous()
    _check(lens, "lengths", torch.int32, (B,))
    dev = q.device
    if k.device != dev or v.device != dev or lens.device != dev:
        raise ValueError("flash_decode inputs lie on different devices")
    if scale is None:
        scale = D ** -0.5
    o = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.tri_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            o.data_ptr(), _DTYPE_CODE[q.dtype], B, L, H, K, D, Dv,
            float(scale), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_decode: CUDA launch failed with cudaError {rc}")
    return o
