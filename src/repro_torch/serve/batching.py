"""Continuous-batching primitives: requests, the FIFO admission queue, and
the rung-admission rule — a copy of ``repro/serve/batching.py``, which is
plain Python (the port imports nothing of the reference package).

The serving batch is a fixed-width slot array at one of the configured
batch rungs. Each slot holds at most one in-flight request with its own
decode position (``Request.index``), so slots advance independently and a
new request can be admitted mid-flight (token-level continuous batching).
A queued request is admitted when a slot is free at the current rung, or
when the rung can grow to a larger configured rung that the memory
controller says fits. The rung shrinks only when the surviving requests
fit in the smaller rung: in-flight work is never evicted.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    """One serving request. ``inputs`` holds UNBATCHED arrays: ``tokens``
    (P,), optionally ``frontend_embeds`` (Se, F) for enc-dec, or ``images``
    (H, W, C) for the vision testbed.

    Scheduling metadata (for the SLO scheduler): ``priority`` is the SLO
    class (0 = most urgent), ``deadline_ms`` an optional completion deadline
    relative to ``submit_time``. The FIFO queue carries both unused."""

    rid: int
    inputs: Dict[str, np.ndarray]
    max_new_tokens: int = 16
    priority: int = 1
    deadline_ms: Optional[float] = None
    # queued | prefilling | active | done | rejected | failed
    status: str = "queued"
    tokens: List[int] = dataclasses.field(default_factory=list)
    #: OOM-recovery evictions so far: each shed requeues the request for a
    #: from-scratch admission until the session's ``max_request_retries``
    #: budget is spent, then status="failed"
    retries: int = 0
    result: Optional[int] = None      # vision: predicted class
    slot: Optional[int] = None
    index: int = 0                    # next decode position
    prefill_pos: int = 0              # prompt tokens consumed (chunked)
    submitted_step: int = -1
    admitted_step: int = -1
    first_token_step: int = -1
    finished_step: int = -1
    submit_time: float = 0.0          # wall clocks for latency percentiles
    first_token_time: float = 0.0
    finish_time: float = 0.0

    @property
    def done(self) -> bool:
        return self.status == "done"

    @property
    def prompt_len(self) -> int:
        t = self.inputs.get("tokens")
        return int(t.shape[-1]) if t is not None else 0


class RequestQueue:
    """FIFO queue with stable ids — the degenerate admission policy
    (priority/deadline-aware admission lives in ``serve.scheduler``)."""

    def __init__(self):
        self._q: collections.deque = collections.deque()
        self._next_rid = 0

    def submit(self, inputs: Dict[str, np.ndarray],
               max_new_tokens: int = 16, priority: int = 1,
               deadline_ms: Optional[float] = None,
               submitted_step: int = -1) -> Request:
        req = Request(rid=self._next_rid,
                      inputs={k: np.asarray(v) for k, v in inputs.items()},
                      max_new_tokens=max_new_tokens, priority=priority,
                      deadline_ms=deadline_ms, submitted_step=submitted_step,
                      submit_time=time.time())
        self._next_rid += 1
        self._q.append(req)
        return req

    def pop(self, **ctx) -> Optional[Request]:
        """FIFO pop; the scheduling context (``now_step``/latency estimates)
        that drives the SLO scheduler is accepted and ignored."""
        del ctx
        return self._q.popleft() if self._q else None

    def requeue(self, req: Request) -> None:
        """Re-enter a request evicted by OOM recovery at the FRONT of the
        queue: it already waited its turn once."""
        req.status = "queued"
        self._q.appendleft(req)

    def depth_by_class(self) -> Dict[int, int]:
        depth: Dict[int, int] = {}
        for r in self._q:
            depth[r.priority] = depth.get(r.priority, 0) + 1
        return depth

    def __len__(self) -> int:
        return len(self._q)


def pick_rung(rungs: Sequence[int], active: int, queued: int,
              capacity_rung: int, latency_rung: Optional[int] = None) -> int:
    """The serving rung for the current load: the smallest configured rung
    covering ``active + queued`` requests, capped by the memory controller's
    ``capacity_rung`` AND the latency controller's ``latency_rung`` (the
    largest rung whose modeled p99 step time fits the tightest class budget
    — None means no latency ceiling) — but never below the smallest rung
    that still holds every in-flight request (no eviction)."""
    want = max(active + queued, 1)
    target = rungs[-1]
    for r in rungs:
        if r >= want:
            target = r
            break
    target = min(target, capacity_rung)
    if latency_rung is not None:
        target = min(target, latency_rung)
    for r in rungs:                      # floor: active requests must fit
        if r >= active:
            return max(target, r)
    return rungs[-1]
