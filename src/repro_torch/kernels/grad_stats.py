"""Gradient statistics: (sum, sum of squares, absmax) of all elements of a
tensor, accumulated in f32 — the inputs of Tri-Accel's per-layer
gradient-variance EMA (``repro/kernels/grad_stats.py``).

Two forms: the hand-written CUDA kernel for Hopper (``csrc/grad_stats.cu``,
bound through ``ctypes``: ``grad_stats_cuda``) and its plain PyTorch version
(``grad_stats_ref``, the port of ``repro/kernels/ref.py:grad_stats_ref``).
``kernels.ops.grad_stats`` routes a CPU tensor to the plain version and a
CUDA tensor to the kernel. Both return three 0-d f32 tensors on the input's
device, with no host read; NaN and inf propagate into the sums and the
absmax as in the reference. An empty tensor gives (0, 0, 0), as the
reference's kernel does on its one zero-padded tile (the CUDA kernel
launches for it too).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def grad_stats_ref(x: torch.Tensor):
    """Plain PyTorch (sum, sum_sq, absmax) over all elements, in f32."""
    xf = x.float()
    if xf.numel() == 0:
        return xf.new_zeros(()), xf.new_zeros(()), xf.new_zeros(())
    return xf.sum(), (xf * xf).sum(), xf.abs().amax()


# ================================================= CUDA kernel ==========
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long


def _lib() -> ctypes.CDLL:
    lib = _build.load("grad_stats")
    if lib.tri_grad_stats.argtypes is None:    # first use: declare the ABI
        lib.tri_grad_stats_blocks.argtypes = [_L, _I]
        lib.tri_grad_stats_blocks.restype = _I
        lib.tri_grad_stats.argtypes = [_P, _I, _L, _P, _I, _P, _P]
        lib.tri_grad_stats.restype = _I
    return lib


def grad_stats_cuda(x: torch.Tensor):
    """The CUDA kernel: a per-block pass and a fixed-order reduce of its
    partials. A non-contiguous ``x`` is copied to a contiguous flat tensor
    first (``reshape(-1)``, then ``contiguous()``)."""
    if not x.is_cuda:
        raise ValueError(f"x: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x: dtype {x.dtype} not in {tuple(_DTYPE_CODE)}")
    flat = x.reshape(-1).contiguous()
    code, n = _DTYPE_CODE[x.dtype], flat.numel()
    lib = _lib()
    nblk = lib.tri_grad_stats_blocks(n, code)
    partials = torch.empty((3 * nblk,), dtype=torch.float32, device=x.device)
    out = torch.empty((3,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.tri_grad_stats(
            flat.data_ptr(), code, n, partials.data_ptr(), nblk,
            out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grad_stats: CUDA launch failed with cudaError "
                           f"{rc}")
    return out[0], out[1], out[2]
