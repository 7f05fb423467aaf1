"""SLO-aware admission scheduling and the measured per-step latency table,
a copy of ``repro/serve/scheduler.py`` (plain Python with numpy; the port
imports nothing of the reference package).

``Scheduler`` takes the FIFO queue's place (``batching.RequestQueue``
stays as the degenerate policy; both have ``submit``/``pop``/``requeue``/
``__len__``, so ``ServeSession`` holds either):

  * every request carries a ``priority`` class (0 = most urgent) and an
    optional ``deadline_ms`` relative to its submit wall time;
  * admission order is earliest-deadline-first within the most urgent
    effective class present (requests without a deadline after those
    with one in the same class, FIFO by rid among equals);
  * aging: a request's effective class improves by one for every
    ``aging_steps`` scheduler steps it has waited, so a steady stream of
    urgent arrivals cannot park a background request forever;
  * infeasible deadlines are handled at pop time, when the latency table
    can price the work: a request whose modeled completion already
    overshoots its deadline is rejected (``on_infeasible="reject"``,
    status ``rejected``, never holds a slot) or degraded (``"degrade"``:
    deadline dropped, demoted below every queued class).

``LatencyTable`` records each decode step's wall time per (rung, tier);
``p99_model`` extrapolates unmeasured rungs linearly from the nearest
measured one, and ``latency_rung`` is the rung controller's ceiling: the
largest rung whose modeled p99 step time fits the tightest class budget.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.batching import Request

_INF = float("inf")


class LatencyTable:
    """Measured per-step decode wall time per (rung, tier), ring-buffered.

    The time-axis twin of ``MemoryModel.measured``: measured-first, with a
    nearest-rung linear extrapolation for never-measured rungs so the climb
    guard can price a rung before ever running it."""

    def __init__(self, window: int = 256):
        self.window = int(window)
        self._samples: Dict[Tuple[int, int], List[float]] = {}

    def record(self, rung: int, tier: int, seconds: float) -> None:
        buf = self._samples.setdefault((int(rung), int(tier)), [])
        buf.append(float(seconds))
        if len(buf) > self.window:
            del buf[: len(buf) - self.window]

    def samples(self, rung: int, tier: int) -> List[float]:
        return list(self._samples.get((int(rung), int(tier)), ()))

    def _pct(self, rung: int, tier: int, q: float) -> Optional[float]:
        buf = self._samples.get((int(rung), int(tier)))
        if not buf:
            return None
        return float(np.percentile(np.asarray(buf), q))

    def p50(self, rung: int, tier: int) -> Optional[float]:
        return self._pct(rung, tier, 50.0)

    def p99(self, rung: int, tier: int) -> Optional[float]:
        return self._pct(rung, tier, 99.0)

    def p99_model(self, rung: int, tier: int) -> Optional[float]:
        """Measured-first p99 step seconds for ``rung``: the empirical
        percentile when this (rung, tier) has samples, else the nearest
        measured rung's p99 scaled linearly by the rung ratio. None when
        the tier has no samples at any rung (no ceiling can apply)."""
        direct = self.p99(rung, tier)
        if direct is not None:
            return direct
        measured = [r for (r, t) in self._samples if t == int(tier)
                    and self._samples[(r, t)]]
        if not measured:
            return None
        near = min(measured, key=lambda r: abs(r - rung))
        return self.p99(near, tier) * (rung / near)

    def latency_rung(self, rungs: Sequence[int], tier: int,
                     budget_s: Optional[float]) -> Optional[int]:
        """Largest configured rung whose modeled p99 step time fits
        ``budget_s`` (at least the smallest rung — the ceiling throttles
        climbing, it never makes serving impossible). None when there is no
        budget or no measurement to model from."""
        if budget_s is None:
            return None
        best = None
        for r in rungs:
            p = self.p99_model(r, tier)
            if p is None:
                return None
            if p <= budget_s:
                best = r
        return best if best is not None else rungs[0]


# ----------------------------------------------------------- scheduler -----
@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    aging_steps: int = 64          # waited steps per one-class promotion
    on_infeasible: str = "reject"  # "reject" | "degrade"

    def __post_init__(self):
        if self.aging_steps < 1:
            raise ValueError(f"aging_steps must be >= 1, got {self.aging_steps}")
        if self.on_infeasible not in ("reject", "degrade"):
            raise ValueError(f"on_infeasible must be 'reject' or 'degrade', "
                             f"got {self.on_infeasible!r}")


class Scheduler:
    """Priority/deadline admission queue (drop-in for ``RequestQueue``)."""

    def __init__(self, cfg: Optional[SchedulerConfig] = None):
        self.cfg = cfg if cfg is not None else SchedulerConfig()
        self._q: List[Request] = []
        self._next_rid = 0
        self.rejected: List[Request] = []

    # ------------------------------------------------------------ intake --
    def submit(self, inputs, max_new_tokens: int = 16, priority: int = 1,
               deadline_ms: Optional[float] = None,
               submitted_step: int = -1) -> Request:
        req = Request(rid=self._next_rid,
                      inputs={k: np.asarray(v) for k, v in inputs.items()},
                      max_new_tokens=max_new_tokens, priority=int(priority),
                      deadline_ms=deadline_ms, submitted_step=submitted_step,
                      submit_time=time.time())
        self._next_rid += 1
        self._q.append(req)
        return req

    def __len__(self) -> int:
        return len(self._q)

    def requeue(self, req: Request) -> None:
        """Re-enter a request evicted by OOM recovery.
        Ordering needs no special-casing: ``rank`` keys on the ORIGINAL
        ``submitted_step``, so the accumulated aging credit persists and
        the request re-sorts ahead of younger peers of its class."""
        req.status = "queued"
        self._q.append(req)

    def depth_by_class(self) -> Dict[int, int]:
        """Queue depth per priority class — the control loop's view of the
        backlog (nominal class, not the aged effective class)."""
        depth: Dict[int, int] = {}
        for r in self._q:
            depth[r.priority] = depth.get(r.priority, 0) + 1
        return depth

    def priorities_queued(self) -> List[int]:
        return sorted({r.priority for r in self._q})

    # ----------------------------------------------------------- ordering --
    def effective_class(self, req: Request, now_step: int) -> int:
        """Nominal class improved one level per ``aging_steps`` waited."""
        waited = max(0, now_step - max(req.submitted_step, 0))
        return req.priority - waited // self.cfg.aging_steps

    def _rank(self, req: Request, now_step: int):
        # deadline-less requests sort after any deadline within the class
        dl = req.deadline_ms if req.deadline_ms is not None else _INF
        return (self.effective_class(req, now_step), dl, req.rid)

    def _estimate_ms(self, req: Request, est_admit_ms,
                     est_step_ms: float) -> float:
        """Modeled time-to-completion from admission now: prompt ingestion
        plus one decode step per remaining output token. ``est_admit_ms``
        may be a per-request callable (chunked prefill prices admission by
        prompt length) or a flat float."""
        admit = est_admit_ms(req) if callable(est_admit_ms) else est_admit_ms
        return admit + est_step_ms * max(req.max_new_tokens - 1, 0)

    def pop(self, now_step: int = 0, now: Optional[float] = None,
            est_admit_ms: float = 0.0, est_step_ms: float = 0.0,
            **ctx) -> Optional[Request]:
        """Next request to admit: earliest-deadline within the most urgent
        effective class. Requests whose deadline is already infeasible under
        the latency estimates are rejected or degraded instead of admitted
        (zero estimates — nothing measured yet — price every deadline as
        feasible)."""
        del ctx
        now = time.time() if now is None else now
        while self._q:
            best = min(self._q, key=lambda r: self._rank(r, now_step))
            if best.deadline_ms is not None:
                slack = best.deadline_ms - (now - best.submit_time) * 1e3
                if self._estimate_ms(best, est_admit_ms, est_step_ms) > slack:
                    self._q.remove(best)
                    if self.cfg.on_infeasible == "degrade":
                        best.deadline_ms = None
                        best.priority = max([r.priority for r in self._q],
                                            default=best.priority) + 1
                        self._q.append(best)
                    else:
                        best.status = "rejected"
                        self.rejected.append(best)
                    continue
            self._q.remove(best)
            return best
        return None
