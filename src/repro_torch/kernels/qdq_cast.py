"""Tier cast (quantize-dequantize): round a tensor to the grid of the
Tri-Accel precision tier that ``code`` picks (0 = low tier, 1 = bf16,
2 = keep). The low tier is fp8 e4m3 with a per-tensor scale 448/amax (tpu
ladder) or fp16 (gpu ladder). Input f32 or bf16; the output type is
``out_dtype`` (f32 or bf16, by default the input's), rounded to nearest
even from the f32 result, as a cast after the cast would.

Two forms: the hand-written CUDA kernel for Hopper (``csrc/qdq_cast.cu``,
bound through ``ctypes``: ``qdq_cast_cuda``) and its plain PyTorch version
(``qdq_cast_ref``), which mirrors ``repro/kernels/ref.py:qdq_cast_ref`` and
the Pallas kernel's single-phase form with a given ``amax``. Both round
fp8 with the reference's overflow rule (NaN past 464), through
``fused_update._fp8_round`` here and ``tier_round.cuh`` in CUDA.
The kernel has two forms of its own, and ``form`` alone picks the one a
call launches: the two-pass form finds the absmax itself (tpu ladder,
code 0, no ``amax``); the one-pass form takes every other call. ``kernels.ops`` routes a CPU tensor to the plain
version and a CUDA tensor to the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_update import _fp8_round, cast_scales

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LADDERS = ("gpu", "tpu")


def form(code, ladder: str, amax) -> str:
    """The kernel's form for a call: "two_pass" where it must find the
    absmax itself (tpu ladder, code 0, no ``amax``), else "one_pass" (the
    output reads no absmax, or is given one)."""
    two = ladder == "tpu" and amax is None and int(code) == 0
    return "two_pass" if two else "one_pass"


def qdq_cast_ref(x: torch.Tensor, code: int, ladder: str = "tpu",
                 amax: Optional[torch.Tensor] = None, *,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch tier cast; ``amax`` (a scalar tensor) replaces the
    tensor's own absmax on the tpu ladder. The result is rounded in f32 and
    cast to ``out_dtype`` (default: ``x``'s type) last."""
    if ladder not in _LADDERS:
        raise ValueError(f"unknown ladder {ladder!r}")
    xf = x.float()
    code = int(code)
    if code == 0:
        if ladder == "tpu":
            if amax is None:
                amax = xf.abs().amax() if xf.numel() else xf.new_zeros(())
            # 448 / amax as a true division (``448.0 / tensor`` would be a
            # reciprocal and a multiply, one ulp off for some amax); 1 where
            # amax is 0 or NaN, as the reference's jnp.where gives
            scale = cast_scales(torch.as_tensor(amax, dtype=torch.float32,
                                                device=xf.device))
            out = _fp8_round(xf * scale) / scale
        else:
            out = xf.to(torch.float16).float()
    elif code == 1:
        out = xf.to(torch.bfloat16).float()
    else:
        out = xf
    return out.to(out_dtype or x.dtype)


# ================================================= CUDA kernel ==========
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long


def _lib() -> ctypes.CDLL:
    lib = _build.load("qdq_cast")
    if lib.tri_qdq_cast.argtypes is None:      # first use: declare the ABI
        lib.tri_qdq_cast.argtypes = [_P, _I, _P, _I, _L, _I, _I, _P, _I,
                                     _P, _I, _P]
        lib.tri_qdq_cast.restype = _I
        lib.tri_qdq_cast_max_grid.argtypes = []
        lib.tri_qdq_cast_max_grid.restype = _I
    return lib


def qdq_cast_cuda(x: torch.Tensor, code: int, ladder: str = "tpu",
                  amax: Optional[torch.Tensor] = None, *,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The CUDA kernel: one launch of either form (``form``), none for an
    empty tensor; the output is a fresh tensor of ``out_dtype``."""
    if not x.is_cuda:
        raise ValueError(f"x: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x: dtype {x.dtype} not in {tuple(_DTYPE_CODE)}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype {out_dtype} not in {tuple(_DTYPE_CODE)}")
    if ladder not in _LADDERS:
        raise ValueError(f"unknown ladder {ladder!r}")
    code = int(code)
    if code not in (0, 1, 2):
        raise ValueError(f"code must be 0, 1 or 2, got {code}")
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    amax_in = None
    if amax is not None and ladder == "tpu":
        amax_in = torch.as_tensor(amax, dtype=torch.float32,
                                  device=x.device).reshape(1).contiguous()
    lib = _lib()
    with torch.cuda.device(x.device):
        # scratch for the two-pass form: one word a block of its grid
        grid = lib.tri_qdq_cast_max_grid()
        partials = torch.empty((grid,), dtype=torch.int32, device=x.device)
        rc = lib.tri_qdq_cast(
            x.data_ptr(), _DTYPE_CODE[x.dtype], out.data_ptr(),
            _DTYPE_CODE[out_dtype], x.numel(), code, int(ladder == "tpu"),
            amax_in.data_ptr() if amax_in is not None else None,
            int(form(code, ladder, amax) == "two_pass"),
            partials.data_ptr(), grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qdq_cast: CUDA launch failed with cudaError {rc}")
    return out
