"""Fused update phase: two slab sweeps for stats + clip + optimizer + master
update + next-step cast, over the ``SlabView`` layout.

  phase 1  ``fused_stats``  — one read of the gradient slab gives the
           per-layer (sum, sum_sq, absmax, nonfinite) vectors (the global
           sq-norm is the sum of sum_sq; the finite gate is nonfinite == 0).
  phase 2  ``fused_apply``  — a second (final) read of each gradient tile
           with the master/moment tiles: unscale -> clip -> sgdm/adamw ->
           per-row lr step -> f32 master write -> the next step's compute
           copy (container cast, optional bf16 stochastic rounding, tier
           rounding) -> per-layer absmax of the copy.

Each phase has two forms here: the hand-written CUDA kernel for Hopper
(``csrc/fused_update.cu``, bound through ``ctypes``: ``*_cuda``) and its
plain PyTorch version (``*_ref``), which repeats the reference's arithmetic
operation by operation. ``kernels.ops`` routes a CPU tensor to the plain
version and a CUDA tensor to the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.layout import SLAB_M, SLAB_N, SlabView

FP8_MAX = 448.0
#: |x| past which the reference's float8_e4m3fn cast gives NaN (the midpoint
#: between 448 and the NaN code); torch's cast saturates instead
FP8_NAN_ABOVE = 464.0
_U32 = 0xFFFFFFFF


class OptSpec(NamedTuple):
    """Static optimizer hyperparameters the kernel specializes on."""
    kind: str                   # "sgdm" | "adamw"
    momentum: float = 0.9
    nesterov: bool = False
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0


# ================================================= plain helper math ====
def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 ``a`` in [0, 2^32) and a uint32 constant,
    split in 16-bit halves so no int64 product overflows."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32


def _sr_bits(rows: int, seed: torch.Tensor, device=None) -> torch.Tensor:
    """Counter-based PRNG of the reference's non-TPU path: one uint32 (held
    in int64) per (global row, lane), a murmur3-finalizer mix of (row,
    lane, step seed)."""
    device = seed.device if device is None else device
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(SLAB_N, dtype=torch.int64, device=device)[None, :]
    seed = seed.to(torch.int64) & _U32
    h = _mul32(r, 0x9E3779B9) ^ _mul32(c, 0x85EBCA6B) ^ _mul32(seed,
                                                               0xC2B2AE35)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _sr_to_bf16(pn: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Stochastic round f32 -> the bf16 grid, bitwise: add the low 16
    random bits to the f32 pattern, truncate the mantissa tail; inf/nan
    take the round-to-nearest cast."""
    u = pn.view(torch.int32).to(torch.int64) & _U32
    usr = (u + (bits & 0xFFFF)) & 0xFFFF0000
    usr = torch.where(usr >= 2 ** 31, usr - 2 ** 32, usr)
    snapped = usr.to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(pn), snapped,
                       pn.to(torch.bfloat16).float())


def _fp8_round(y: torch.Tensor) -> torch.Tensor:
    """f32 -> float8_e4m3fn -> f32 with the reference's overflow: NaN past
    464 and for inf (torch's own cast saturates to 448)."""
    f = y.to(torch.float8_e4m3fn).float()
    return torch.where(y.abs() <= FP8_NAN_ABOVE, f, torch.nan)


def _tier_select(cwf, code, qs, ladder: str):
    """qdq_cast's tier math with a per-ROW fp8 scale column ``qs``."""
    if ladder == "tpu":
        low = _fp8_round(cwf * qs) / qs
    else:
        low = cwf.to(torch.float16).float()
    mid = cwf.to(torch.bfloat16).float()
    return torch.where(code == 0, low, torch.where(code == 1, mid, cwf))


def _segment_max(vals: torch.Tensor, ids: torch.Tensor, L: int):
    """Per-layer max of non-negative row values; empty layers give 0."""
    out = torch.zeros((L,), dtype=torch.float32, device=vals.device)
    return out.scatter_reduce(0, ids, vals, "amax", include_self=True)


def cast_scales(p_amax: torch.Tensor) -> torch.Tensor:
    """Per-layer fp8 cast scales from the carried param absmax."""
    return torch.where(p_amax > 0, p_amax.new_full((), FP8_MAX) / p_amax,
                       1.0)


# ============================================== plain versions ==========
def fused_stats_ref(g_slab, row_layer, num_layers: int):
    """Plain PyTorch phase 1 -> four (num_layers,) f32 vectors (sum,
    sum_sq, absmax, nonfinite). Non-finite lanes are counted but left out
    of the moments; empty layers give 0 absmax."""
    x = g_slab.float()
    ok = torch.isfinite(x)
    xf = torch.where(ok, x, 0.0)
    ids = row_layer.reshape(-1).long()
    L = num_layers

    def seg_sum(v):
        return torch.zeros((L,), dtype=torch.float32,
                           device=v.device).index_add_(0, ids, v)

    rs = xf.sum(dim=1)
    rss = (xf * xf).sum(dim=1)
    rnf = (~ok).float().sum(dim=1)
    rmx = xf.abs().amax(dim=1)
    return seg_sum(rs), seg_sum(rss), _segment_max(rmx, ids, L), seg_sum(rnf)


def fused_apply_ref(g_slab, p_slab, m_slab, v_slab, scalars, row_layer,
                    lr_rows, code_rows, qs_rows, *, spec: OptSpec,
                    ladder: str, cp_dtype, num_layers: int,
                    sr: bool = False):
    """Plain PyTorch phase 2 -> (p_new, m_new, v_new | None, compute_copy,
    p_amax (L,)). ``scalars`` = [gscale, keep, c1, c2, sr_seed]; ``sr``
    applies only to a bf16 copy."""
    sr = bool(sr) and cp_dtype == torch.bfloat16
    keep = scalars[1] > 0.0
    g = g_slab.float() * scalars[0]                       # unscale + clip
    p = p_slab.float()
    v2 = None
    if spec.kind == "sgdm":
        if spec.weight_decay:
            g = g + spec.weight_decay * p
        m2 = spec.momentum * m_slab + g
        step = (spec.momentum * m2 + g) if spec.nesterov else m2
    else:
        m2 = spec.b1 * m_slab + (1.0 - spec.b1) * g
        v2 = spec.b2 * v_slab + (1.0 - spec.b2) * (g * g)
        step = (m2 / scalars[2]) / (torch.sqrt(v2 / scalars[3]) + spec.eps)
        if spec.weight_decay:
            step = step + spec.weight_decay * p
    pn = p - lr_rows.reshape(-1, 1) * step
    pn = torch.where(keep, pn, p)                         # non-finite skip
    m2 = torch.where(keep, m2, m_slab)
    if v2 is not None:
        v2 = torch.where(keep, v2, v_slab)
    if sr:
        cwf = _sr_to_bf16(pn, _sr_bits(pn.shape[0], scalars[4]))
    else:
        cwf = pn.to(cp_dtype).float()
    cp = _tier_select(cwf, code_rows.reshape(-1, 1), qs_rows.reshape(-1, 1),
                      ladder).to(cp_dtype)
    pmax = _segment_max(cwf.abs().amax(dim=1), row_layer.reshape(-1).long(),
                        num_layers)
    return pn, m2, v2, cp, pmax


# ================================================ CUDA kernels ==========
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_update")
    if lib.tri_fused_stats.argtypes is None:   # first use: declare the ABI
        lib.tri_rows_per_block.argtypes = []
        lib.tri_rows_per_block.restype = _I
        lib.tri_fused_stats.argtypes = [_P, _I, _P, _I, _I, _P, _P, _P]
        lib.tri_fused_stats.restype = _I
        lib.tri_fused_apply.argtypes = (
            [_I] * 6 + [_F] * 7 + [_P] * 15 + [_I, _I, _P])
        lib.tri_fused_apply.restype = _I
    return lib


def _check(t: torch.Tensor, name: str, dtype=None, shape=None,
           dtypes=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if dtypes is not None and t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def fused_stats_cuda(g_slab, row_layer, num_layers: int):
    """Phase-1 CUDA kernel: one gradient read -> four (L,) f32 vectors."""
    rows = g_slab.shape[0]
    if g_slab.dim() != 2 or g_slab.shape[1] != SLAB_N or rows % SLAB_M:
        raise ValueError(f"g_slab: expected (k*{SLAB_M}, {SLAB_N}), got "
                         f"{tuple(g_slab.shape)}")
    _check(g_slab, "g_slab", dtypes=tuple(_DTYPE_CODE))
    _check(row_layer, "row_layer", torch.int32, (rows // SLAB_M, SLAB_M))
    if row_layer.device != g_slab.device:
        raise ValueError("row_layer and g_slab lie on different devices")
    lib = _lib()
    L = int(num_layers)
    dev = g_slab.device
    partials = torch.empty((rows // lib.tri_rows_per_block()) * L * 4,
                           dtype=torch.float32, device=dev)
    out = torch.empty((4, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.tri_fused_stats(
            g_slab.data_ptr(), _DTYPE_CODE[g_slab.dtype],
            row_layer.data_ptr(), rows, L, partials.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "fused_stats")
    return out[0], out[1], out[2], out[3]


def fused_apply_cuda(g_slab, p_slab, m_slab, v_slab, scalars, row_layer,
                     lr_rows, code_rows, qs_rows, *, spec: OptSpec,
                     ladder: str, cp_dtype, num_layers: int,
                     sr: bool = False):
    """Phase-2 CUDA kernel -> (p_new, m_new, v_new | None, compute_copy,
    p_amax (L,)); outputs are fresh tensors."""
    rows = p_slab.shape[0]
    shape = (rows, SLAB_N)
    meta = (rows // SLAB_M, SLAB_M)
    if rows % SLAB_M or tuple(p_slab.shape) != shape:
        raise ValueError(f"p_slab: expected (k*{SLAB_M}, {SLAB_N}), got "
                         f"{tuple(p_slab.shape)}")
    if ladder not in ("gpu", "tpu"):
        raise ValueError(f"unknown ladder {ladder!r}")
    if cp_dtype not in _DTYPE_CODE:
        raise ValueError(f"cp_dtype {cp_dtype} not in {tuple(_DTYPE_CODE)}")
    adam = spec.kind == "adamw"
    if not adam and spec.kind != "sgdm":
        raise ValueError(f"unknown optimizer kind {spec.kind!r}")
    _check(g_slab, "g_slab", shape=shape, dtypes=tuple(_DTYPE_CODE))
    _check(p_slab, "p_slab", torch.float32, shape)
    _check(m_slab, "m_slab", torch.float32, shape)
    if adam:
        _check(v_slab, "v_slab", torch.float32, shape)
    _check(scalars, "scalars", torch.float32, (5,))
    _check(row_layer, "row_layer", torch.int32, meta)
    _check(lr_rows, "lr_rows", torch.float32, meta)
    _check(code_rows, "code_rows", torch.int32, meta)
    _check(qs_rows, "qs_rows", torch.float32, meta)
    dev = p_slab.device
    if any(t.device != dev for t in (g_slab, m_slab, scalars, row_layer,
                                     lr_rows, code_rows, qs_rows)):
        raise ValueError("fused_apply inputs lie on different devices")
    lib = _lib()
    L = int(num_layers)
    p_new = torch.empty(shape, dtype=torch.float32, device=dev)
    m_new = torch.empty(shape, dtype=torch.float32, device=dev)
    v_new = torch.empty(shape, dtype=torch.float32, device=dev) \
        if adam else None
    cp = torch.empty(shape, dtype=cp_dtype, device=dev)
    partials = torch.empty((rows // lib.tri_rows_per_block()) * L,
                           dtype=torch.float32, device=dev)
    pmax = torch.empty((L,), dtype=torch.float32, device=dev)
    ptr = lambda t: t.data_ptr() if t is not None else None
    with torch.cuda.device(dev):
        rc = lib.tri_fused_apply(
            int(adam), int(ladder == "tpu"), _DTYPE_CODE[g_slab.dtype],
            _DTYPE_CODE[cp_dtype], int(bool(sr)), int(bool(spec.nesterov)),
            spec.momentum, spec.b1, 1.0 - spec.b1, spec.b2, 1.0 - spec.b2,
            spec.eps, spec.weight_decay,
            ptr(g_slab), ptr(p_slab), ptr(m_slab),
            ptr(v_slab) if adam else None, ptr(scalars), ptr(row_layer),
            ptr(lr_rows), ptr(code_rows), ptr(qs_rows), ptr(p_new),
            ptr(m_new), ptr(v_new), ptr(cp), ptr(partials), ptr(pmax),
            rows, L, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "fused_apply")
    return p_new, m_new, v_new, cp, pmax


# ========================================================= helpers ======
def seed_compute(view: SlabView, params, codes: torch.Tensor, ladder: str,
                 cp_dtype, slab: bool = False) -> Dict[str, Any]:
    """Init/reseed the carried compute state: the compute copy the FIRST
    fused step's forward consumes, plus the per-layer param absmax table.
    A one-off pass at trainer init; every later copy comes from the apply
    kernel. With ``slab=True`` the copy stays in slab form."""
    cw = view.pack(params, cp_dtype).float()
    ids = view.row_blocks(cw.device).reshape(-1).long()
    p_amax = _segment_max(cw.abs().amax(dim=1), ids, view.num_layers)
    code_r = view.gather_rows(codes).reshape(-1, 1)
    qs_r = view.gather_rows(cast_scales(p_amax)).reshape(-1, 1)
    cp = _tier_select(cw, code_r, qs_r, ladder).to(cp_dtype)
    if slab:
        return {"slab": cp, "p_amax": p_amax}
    return {"tree": view.unpack(cp, like=params), "p_amax": p_amax}
