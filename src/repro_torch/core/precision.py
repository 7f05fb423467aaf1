"""Tri-Accel §3.1 — Precision-Adaptive Updates (control math).

Per-layer precision codes (0 = low tier, 1 = bf16, 2 = fp32) are selected
from an EMA of per-layer gradient variance against thresholds (tau_low,
tau_high), with §3.2's curvature promotion overriding to fp32 above
tau_curv. On the fused path the codes are actuated by the apply kernel's
next-step cast (``kernels.fused_update``).

Ladders:
    gpu: fp16 / bf16 / fp32   (paper-faithful)
    tpu: fp8_e4m3 (per-layer amax scaling) / bf16 / fp32
"""
from __future__ import annotations

import dataclasses

import torch

LADDERS = {"gpu": ("fp16", "bf16", "fp32"), "tpu": ("fp8", "bf16", "fp32")}

FP8_MAX = 448.0  # float8_e4m3fn max normal


def refuse_qdq(codes, qdq_fn) -> None:
    """The resident fused path passes no in-loss precision emulation: the
    apply kernel casts. Anything else belongs to ``reference_step``."""
    if codes is not None or qdq_fn is not None:
        raise NotImplementedError(
            "in-loss QDQ precision emulation belongs to reference_step, "
            "which is not ported yet (ROADMAP A6); the fused path casts in "
            "the apply kernel")


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
