"""Public wrappers for the fused-update kernels.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor goes to the hand-written CUDA kernel, or the call raises. Nothing
falls back. Each wrapper counts its kernel launches in ``LAUNCHES`` (a
plain integer per kernel, bumped only where the kernel is launched), so a
run can show that the main path went through the kernels.
"""
from __future__ import annotations

from repro_torch.kernels import fused_update as _fu

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = {"fused_stats": 0, "fused_apply": 0}


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
