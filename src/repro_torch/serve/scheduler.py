"""The measured per-step latency table that the serving session reads, as
``repro/serve/scheduler.py:LatencyTable`` (plain Python). The SLO
``Scheduler`` (priority classes, deadlines, aging) waits for the slice
that ports SLO scheduling; sessions here run the FIFO queue.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


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


