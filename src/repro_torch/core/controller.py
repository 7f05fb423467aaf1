"""Tri-Accel §3.4 — the unified control loop.

``ControlState`` is a small tuple of device tensors (O(L) scalars) carried
through training. The per-step half (variance EMA, code refresh, loss
scaling) runs inside the train step without a host sync; the host-side half
(curvature refresh every t_curv, batch-rung decisions every t_ctrl) lives
in ``repro_torch.train.trainer``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.precision import (TriAccelConfig, codes_from_stats,
                                        ema_update, variance_from_moments)


class ControlState(NamedTuple):
    step: torch.Tensor          # () int32
    var_ema: torch.Tensor       # (L,) gradient-variance EMA per layer
    lam: torch.Tensor           # (L,) curvature estimate per layer
    codes: torch.Tensor         # (L,) int32 precision codes
    loss_scale: torch.Tensor    # () dynamic loss scale (fp16 ladder)
    good_steps: torch.Tensor    # () consecutive finite-grad steps
    ema_init: torch.Tensor      # () has the EMA been seeded
    #: () multiplicative LR demotion: a tensor from ``init_control``, or
    #: the reference's default, a plain 1.0, for a 7-field construction
    lr_demote: Any = 1.0


def init_control(num_layers: int, cfg: TriAccelConfig,
                 device="cpu") -> ControlState:
    f32, i32 = torch.float32, torch.int32
    return ControlState(
        step=torch.zeros((), dtype=i32, device=device),
        var_ema=torch.zeros((num_layers,), dtype=f32, device=device),
        lam=torch.zeros((num_layers,), dtype=f32, device=device),
        codes=torch.ones((num_layers,), dtype=i32, device=device),
        loss_scale=torch.tensor(2.0 ** 15 if cfg.ladder == "gpu" else 1.0,
                                dtype=f32, device=device),
        good_steps=torch.zeros((), dtype=i32, device=device),
        ema_init=torch.zeros((), dtype=i32, device=device),
        lr_demote=torch.ones((), dtype=f32, device=device),
    )


def update_control(state: ControlState, moments, cfg: TriAccelConfig,
                   grads_finite: torch.Tensor) -> ControlState:
    """Per-step update. ``moments`` = (sum, sumsq, count) per layer."""
    s, ss, cnt = moments
    var_now = variance_from_moments(s, ss, cnt)
    seeded = state.ema_init > 0
    var_ema = torch.where(seeded,
                          ema_update(state.var_ema, var_now, cfg.beta),
                          var_now)
    step = state.step + 1
    # refresh codes on the control-loop cadence (t_ctrl), as in §3.4
    new_codes = codes_from_stats(var_ema, state.lam, cfg)
    codes = torch.where((step % cfg.t_ctrl) == 0, new_codes, state.codes)
    # dynamic loss scaling (fp16 ladder only): halve on overflow, double
    # after 1000 clean steps, capped at 2^24 — standard AMP semantics
    if cfg.ladder == "gpu":
        good = torch.where(grads_finite, state.good_steps + 1, 0
                           ).to(torch.int32)
        ls = torch.where(grads_finite,
                         torch.where(good >= 1000, state.loss_scale * 2.0,
                                     state.loss_scale),
                         torch.clamp_min(state.loss_scale * 0.5, 1.0))
        ls = torch.clamp_max(ls, 2.0 ** 24)
        good = torch.where(good >= 1000, 0, good).to(torch.int32)
    else:
        ls, good = state.loss_scale, state.good_steps
    return ControlState(step=step, var_ema=var_ema, lam=state.lam,
                        codes=codes, loss_scale=ls, good_steps=good,
                        ema_init=torch.ones_like(state.ema_init),
                        lr_demote=state.lr_demote)


def with_curvature(state: ControlState, lam: torch.Tensor) -> ControlState:
    """Host-side: install a fresh curvature estimate (every t_curv steps)."""
    return state._replace(lam=lam.to(torch.float32))


def lr_scales(state: ControlState, cfg: TriAccelConfig) -> torch.Tensor:
    """§3.2 step-size scaling: eta_l = eta0 / (1 + alpha * lam_l)."""
    if not cfg.enable_curvature:
        return torch.ones_like(state.lam)
    den = 1.0 + cfg.alpha * torch.clamp_min(state.lam, 0.0)
    return torch.ones_like(den) / den
