"""Traffic generation and trace driving for serving, a copy of
``repro/serve/traffic.py`` (plain Python with numpy).

A workload is a list of ``TrafficClass``es — each one SLO class with its own
arrival process (Poisson rate per step, optionally with periodic bursts on
top), prompt/output length mixes, and deadline. ``poisson_trace`` samples a
deterministic arrival trace from it (seeded; two benches on two archs see
the same offered load), and ``drive`` replays the trace against a
``ServeSession`` step-for-step — arrivals are submitted at their trace step,
so the session's scheduler sees realistic queue dynamics instead of a
pre-loaded queue — then drains, and reports per-class percentiles
(queue wait, time-to-first-token, completion) and the deadline-hit rate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One priority class of offered load.

    ``rate`` is the Poisson mean arrivals per decode step; ``burst_every``/
    ``burst_size`` superimpose a deterministic burst (size arrivals every N
    steps) — the bursty traffic of the serve bench. Prompt and output
    lengths are sampled uniformly from the given mixes."""

    priority: int = 1
    rate: float = 0.1
    prompt_lens: Tuple[int, ...] = (16,)
    new_tokens: Tuple[int, ...] = (16,)
    deadline_ms: Optional[float] = None
    burst_every: Optional[int] = None
    burst_size: int = 0


@dataclasses.dataclass(frozen=True)
class Arrival:
    step: int
    priority: int
    prompt_len: int
    max_new_tokens: int
    deadline_ms: Optional[float]


def poisson_trace(classes: Sequence[TrafficClass], steps: int,
                  seed: int = 0) -> List[Arrival]:
    """Sample a deterministic arrival trace over ``steps`` scheduler steps:
    per class, Poisson(rate) arrivals per step plus the class's periodic
    burst, lengths drawn uniformly from its mixes. Sorted by step."""
    rng = np.random.default_rng(seed)
    trace: List[Arrival] = []
    for tc in classes:
        for t in range(steps):
            k = int(rng.poisson(tc.rate))
            if tc.burst_every and t > 0 and t % tc.burst_every == 0:
                k += int(tc.burst_size)
            for _ in range(k):
                trace.append(Arrival(
                    step=t, priority=tc.priority,
                    prompt_len=int(rng.choice(tc.prompt_lens)),
                    max_new_tokens=int(rng.choice(tc.new_tokens)),
                    deadline_ms=tc.deadline_ms))
    trace.sort(key=lambda a: a.step)
    return trace


def make_prompt(rng: np.random.Generator, length: int,
                vocab: int) -> np.ndarray:
    return rng.integers(0, vocab, (length,), dtype=np.int64).astype(np.int32)


def _pct(xs, q) -> Optional[float]:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None


def class_report(requests) -> Dict[str, Any]:
    """Per-priority-class latency/deadline aggregates over a finished set of
    ``Request``s: completion-latency and queue-wait percentiles, plus the
    deadline-hit rate (completed within ``deadline_ms`` of submit; rejected
    and unfinished deadlined requests count as misses)."""
    by_class: Dict[int, List] = {}
    for r in requests:
        by_class.setdefault(r.priority, []).append(r)
    out: Dict[str, Any] = {}
    for c in sorted(by_class):
        reqs = by_class[c]
        done = [r for r in reqs if r.status == "done"]
        lat = [(r.finish_time - r.submit_time) * 1e3 for r in done]
        q = [r.admitted_step - r.submitted_step for r in done
             if r.admitted_step >= 0]
        dl = [r for r in reqs if r.deadline_ms is not None]
        hits = sum(1 for r in dl if r.status == "done"
                   and (r.finish_time - r.submit_time) * 1e3 <= r.deadline_ms)
        out[str(c)] = {
            "submitted": len(reqs),
            "completed": len(done),
            "rejected": sum(r.status == "rejected" for r in reqs),
            "completion_ms_p50": _pct(lat, 50),
            "completion_ms_p99": _pct(lat, 99),
            "queue_steps_p50": _pct(q, 50),
            "queue_steps_p99": _pct(q, 99),
            "deadline_hit_rate": (hits / len(dl)) if dl else None,
        }
    return out


def drive(session, trace: Sequence[Arrival], vocab: int, seed: int = 0,
          drain_steps: int = 10_000) -> Dict[str, Any]:
    """Replay ``trace`` against ``session`` (arrivals submitted at their
    trace step, one ``session.step()`` per step), then drain. Returns the
    session-level report plus ``classes`` (per-class aggregates) and the
    offered/served counts."""
    rng = np.random.default_rng(seed)
    horizon = max((a.step for a in trace), default=0)
    queue: List[Arrival] = sorted(trace, key=lambda a: a.step)
    t0 = time.time()
    c0 = session.engine.compile_s
    i = 0
    for t in range(horizon + 1):
        while i < len(queue) and queue[i].step <= t:
            a = queue[i]
            session.submit(
                {"tokens": make_prompt(rng, a.prompt_len, vocab)},
                max_new_tokens=a.max_new_tokens, priority=a.priority,
                deadline_ms=a.deadline_ms)
            i += 1
        session.step()
    steps_left = drain_steps
    while (len(session.queue) or session._active()) and steps_left > 0:
        session.step()
        steps_left -= 1
    dt = max(time.time() - t0, 1e-9)
    warm_s = session.engine.compile_s - c0
    serve_s = max(dt - warm_s, 1e-9)
    reqs = list(session.requests.values())
    return {"steps": session.steps, "offered": len(trace),
            "decoded_tokens": session.decoded_tokens,
            "wall_s": dt, "warm_s": warm_s, "serve_s": serve_s,
            "tok_s": session.decoded_tokens / serve_s,
            "compile_count": session.compile_count,
            "rung_history": list(session.rung_history),
            "tier_history": list(session.tier_history),
            "classes": class_report(reqs),
            **session.latency_report()}
