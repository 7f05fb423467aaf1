"""Recovery supervision policies, as the reference's
``repro.resilience.recovery``.

``RecoveryConfig`` sizes the trainer's reactive loops: bounded OOM
retries, the divergence watchdog's window, the rollback budget, and the
deterministic loss-scale / learning-rate demotion a rollback applies.
``DivergenceWatchdog`` is the host-side detector: it folds the per-step
``grads_finite`` / ``loss`` the step already returns into two triggers (a
run of K non-finite steps; a loss spike against the windowed median) and
stays O(1) per step.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional


class DivergenceError(RuntimeError):
    """Training diverged and the rollback budget is exhausted (or there is
    no committed checkpoint to roll back to)."""


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Knobs for the trainer's recovery supervision.

    OOM handling is always on: catching the allocator's error and stepping
    the rung down costs nothing until it fires. The divergence watchdog is
    opt-in (``watchdog=True``): it adds one host read of two scalar
    metrics per step."""

    #: re-dispatches of the SAME batch at successively smaller rungs before
    #: an OOM escalates to checkpoint-and-raise
    max_oom_retries: int = 3
    #: enable the divergence watchdog (rollback supervision)
    watchdog: bool = False
    #: consecutive non-finite steps that trigger a rollback
    max_nonfinite: int = 3
    #: finite-loss window for the spike detector
    loss_window: int = 16
    #: rollback when loss > factor * windowed median (None = off)
    loss_spike_factor: Optional[float] = None
    #: rollbacks before the run aborts with DivergenceError
    max_rollbacks: int = 2
    #: multiplicative loss-scale demotion applied on rollback (the gpu
    #: ladder floors at 1.0, the AMP ladder's own floor)
    loss_scale_demotion: float = 0.5
    #: multiplicative LR demotion applied on rollback (carried in
    #: ControlState.lr_demote, so it survives checkpoint/restore)
    lr_demotion: float = 0.5


class DivergenceWatchdog:
    """Windowed divergence detector over the step metrics stream.

    ``observe(loss, grads_finite)`` returns True when the run should roll
    back: either ``max_nonfinite`` consecutive steps had non-finite grads,
    or (with ``loss_spike_factor`` set) a finite loss exceeded the factor
    times the median of the last ``loss_window`` finite losses."""

    def __init__(self, cfg: RecoveryConfig):
        self.cfg = cfg
        self.nonfinite_run = 0
        self.losses: collections.deque = collections.deque(
            maxlen=cfg.loss_window)

    @property
    def healthy(self) -> bool:
        """No suspect steps in flight: the checkpoint cadence consults this
        so that a mid-burst state (params fine, control poisoned) is never
        committed over the clean generation a rollback needs."""
        return self.nonfinite_run == 0

    def observe(self, loss: float, grads_finite: bool) -> bool:
        finite = bool(grads_finite) and math.isfinite(loss)
        if not finite:
            self.nonfinite_run += 1
            return self.nonfinite_run >= self.cfg.max_nonfinite
        self.nonfinite_run = 0
        spiked = False
        f = self.cfg.loss_spike_factor
        if f is not None and len(self.losses) >= max(self.losses.maxlen // 2,
                                                     2):
            med = sorted(self.losses)[len(self.losses) // 2]
            spiked = loss > f * med
        if not spiked:
            self.losses.append(loss)
        return spiked

    def reset(self) -> None:
        """After a rollback: the restored trajectory starts a fresh
        window."""
        self.nonfinite_run = 0
        self.losses.clear()
