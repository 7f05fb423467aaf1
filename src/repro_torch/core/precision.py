"""Tri-Accel §3.1 — Precision-Adaptive Updates.

Per-layer precision codes (0 = low tier, 1 = bf16, 2 = fp32) are selected
from an EMA of per-layer gradient variance against thresholds (tau_low,
tau_high), with §3.2's curvature promotion overriding to fp32 above
tau_curv. On the fused path the codes are actuated by the apply kernel's
next-step cast (``kernels.fused_update``); on the reference path
(``train_step.reference_step``) by the in-loss quantize-dequantize
``qdq``: weights are rounded to the tier's grid while their dtype stays,
the tier picked on the device from a code tensor, with no host read.

Ladders:
    gpu: fp16 / bf16 / fp32   (paper-faithful)
    tpu: fp8_e4m3 (per-tensor amax scaling) / bf16 / fp32
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import torch

from repro_torch import tree as tu
from repro_torch.kernels.fused_update import _fp8_round, cast_scales

LADDERS = {"gpu": ("fp16", "bf16", "fp32"), "tpu": ("fp8", "bf16", "fp32")}

FP8_MAX = 448.0  # float8_e4m3fn max normal


@dataclasses.dataclass(frozen=True)
class TriAccelConfig:
    # §3.1 precision
    beta: float = 0.9                   # variance EMA smoothing
    tau_low: float = 1e-6               # v < tau_low  -> low tier
    tau_high: float = 1e-3              # v >= tau_high -> fp32
    ladder: str = "gpu"
    dynamic_precision: bool = True      # False -> static precision
    stochastic_round: bool = False      # SR on the fused compute cast
    # §3.2 curvature
    curvature_method: str = "hutchinson"   # "power" | "hutchinson" | "fisher"
    top_k: int = 5
    power_iters: int = 5
    t_curv: int = 200                   # curvature refresh period (steps)
    b_curv: int = 32                    # curvature micro-batch
    alpha: float = 0.1                  # lr scale: eta/(1 + alpha*lam)
    tau_curv: float = 10.0              # promote to fp32 above this curvature
    # §3.3 memory-elastic batch
    rho_low: float = 0.80
    rho_high: float = 0.92
    delta_up: int = 1
    delta_down: int = 1
    mem_cap_bytes: float = 16e9
    # §3.4 control loop
    t_ctrl: int = 50
    # ablation switches (paper Table 2)
    enable_precision: bool = True
    enable_curvature: bool = True
    enable_batch: bool = True


def variance_from_moments(s, ss, cnt):
    mean = s / torch.clamp_min(cnt, 1.0)
    return torch.clamp_min(ss / torch.clamp_min(cnt, 1.0) - mean * mean, 0.0)


def ema_update(v_prev, v_now, beta):
    return beta * v_prev + (1.0 - beta) * v_now


def codes_from_stats(var_ema: torch.Tensor, lam: torch.Tensor,
                     cfg: TriAccelConfig) -> torch.Tensor:
    """§3.1 threshold rule + §3.2 curvature promotion -> (L,) int32 codes."""
    codes = torch.where(var_ema < cfg.tau_low, 0,
                        torch.where(var_ema < cfg.tau_high, 1, 2)
                        ).to(torch.int32)
    if cfg.enable_curvature:
        codes = torch.maximum(
            codes, torch.where(lam > cfg.tau_curv, 2, 0).to(torch.int32))
    if not cfg.enable_precision:
        codes = torch.ones_like(codes)  # static bf16 (AMP)
    return codes


# ------------------------------------------------------------------ QDQ ----
def _qdq_fp16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16).to(x.dtype)


def _qdq_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _qdq_fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor amax-scaled e4m3 rounding (the tpu ladder's low tier),
    with the reference's NaN past 464 (``fused_update._fp8_round``)."""
    xf = x.float()
    scale = cast_scales(xf.abs().amax())
    return (_fp8_round(xf * scale) / scale).to(x.dtype)


def _qdq_fp8_vjp(x: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """The reference's transpose of ``_qdq_fp8`` (``jax.vjp``), operation
    by operation: the cotangent rounds through e4m3 as the forward cast
    transposes (``ct / scale`` to fp8 and back, times ``scale``), plus the
    path through amax -> scale, a full-tensor sum that lands on the absmax
    element(s), shared equally among ties as ``jnp.max``'s rule does. A bf16
    ``x`` gets each path's cotangent cast to bf16 before they add, as the
    reference's two f32 converts of ``x`` do."""
    xf = x.float()
    ax = xf.abs()
    amax = ax.amax()
    hit = (ax == amax).float()
    pos = amax > 0
    scale = cast_scales(amax)
    c = ct.float()
    y = _fp8_round(xf * scale)                    # the forward's grid values
    c8 = _fp8_round(c / scale)                    # cotangent of the cast
    d_scale = (-((c * (1.0 / (scale * scale))) * y).sum()
               + (xf * c8).sum())
    main = c8 * scale
    d_amax = -((torch.where(pos, d_scale, 0.0) * (1.0 / (amax * amax)))
               * FP8_MAX) / hit.sum()
    at_max = d_amax * hit
    zero = torch.zeros_like(at_max)
    up = torch.where(xf >= 0, at_max, zero)       # through |x| = x
    down = -torch.where(xf >= 0, zero, at_max)    # through |x| = -x
    if x.dtype == torch.float32:
        return (main + up) + down
    return main.to(x.dtype) + (up + down).to(x.dtype)


def _mid(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.bfloat16 else _qdq_bf16(x)


def _pick(code, low, mid, keep):
    return torch.where(code == 0, low, torch.where(code == 1, mid, keep))


class _Qdq(torch.autograd.Function):
    """The tier switch on a device code: every tier is computed and
    ``torch.where`` picks one, forward and backward, so the gradient is
    the picked tier's transpose alone (the reference's ``lax.switch``) and
    no host read is needed. Each cast's transpose casts the cotangent the
    same way (JAX's ``convert_element_type`` rule); the fp8 tier's is
    ``_qdq_fp8_vjp``."""

    @staticmethod
    def forward(ctx, x, code, ladder):
        code = code.clamp(0, 2)
        ctx.save_for_backward(x, code)
        ctx.ladder = ladder
        low = _qdq_fp8(x) if ladder == "tpu" else _qdq_fp16(x)
        return _pick(code, low, _mid(x), x)

    @staticmethod
    def backward(ctx, ct):
        x, code = ctx.saved_tensors
        low = (_qdq_fp8_vjp(x, ct) if ctx.ladder == "tpu"
               else _qdq_fp16(ct))
        return _pick(code, low, _mid(ct), ct), None, None


def qdq(x: torch.Tensor, code, ladder: str = "gpu") -> torch.Tensor:
    """Round ``x`` to the grid of the precision tier ``code`` selects (a
    0-d integer tensor, on the device; clamped to 0..2 as ``lax.switch``
    does). Gradients pass through the picked tier's casts."""
    if not x.dtype.is_floating_point:
        return x
    if ladder not in LADDERS:
        raise ValueError(f"unknown ladder {ladder!r}")
    code = torch.as_tensor(code, dtype=torch.int32, device=x.device)
    return _Qdq.apply(x, code, ladder)


def make_qdq_fn(cfg: TriAccelConfig) -> Optional[Callable]:
    """QDQ is applied whenever dynamic_precision is on; enable_precision
    only gates whether the codes ADAPT (False freezes them at the bf16
    tier = the paper's static-AMP baseline)."""
    if not cfg.dynamic_precision:
        return None
    return partial(qdq, ladder=cfg.ladder)


# -------------------------------------------------- variance statistics ----
def moment_stats(tree, layer_axis: bool = False):
    """(sum, sumsq, count) over a layer's floating gradient leaves, in f32.
    With ``layer_axis`` the leaves carry a leading stacked-layer dim that is
    kept: per-layer (n,) vectors."""
    leaves = [l.float() for l in tu.leaves(tree)
              if l.dtype.is_floating_point]
    if layer_axis:
        rows = [l.reshape(l.shape[0], -1) for l in leaves]
        s = sum(r.sum(dim=1) for r in rows)
        ss = sum((r * r).sum(dim=1) for r in rows)
        cnt = sum(float(l.numel()) / l.shape[0] for l in leaves)
        return s, ss, torch.full_like(s, cnt)
    s = sum(l.sum() for l in leaves)
    ss = sum((l * l).sum() for l in leaves)
    cnt = torch.tensor(float(sum(l.numel() for l in leaves)),
                       dtype=torch.float32, device=s.device)
    return s, ss, cnt
