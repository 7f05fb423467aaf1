"""ServeSession: elastic continuous-batching serving over a task (a token
LM, or the vision testbed's cache-free inference), as
``repro/serve/session.py``.

One session owns the admission queue (FIFO, or the SLO scheduler:
priority classes, deadlines, aging; ``serve.scheduler``), a slot array at
the current batch rung, the batched decode caches and a ``ServeEngine``.
Each ``step()``:

  1. control cadence (every ``t_ctrl`` steps): the §3.3 BatchScaler over the
     task's ``serve_memory_model`` updates the memory-capacity rung,
     measured-first (``warm()`` records each (rung, tier) path's peak
     bytes), and, with ``auto_tier``, re-picks the decode-weight tier: the
     highest-precision configured tier whose footprint fits under
     rho_high * cap; the latency ceiling is refreshed from the measured
     per-step latency table: the largest rung whose modeled p99 step time
     fits the tightest budget of the classes present;
  2. rung resize: grow or shrink to the smallest configured rung covering
     the load (never evicting in-flight requests), capped by the memory
     and the latency controllers, repacking cache rows;
  3. admission: queued requests fill free slots in scheduler order.
     Whole-prompt admission scatters one prefill into the slot's cache
     rows; with ``prefill_chunk`` set the prompt (of any length) is
     consumed in chunks instead, one chunk per request per step,
     teacher-forced through the decode hook on the slot's own rows, so a
     long prompt never stalls the in-flight decodes;
  4. one decode step for every active slot, each at its own position;
     empty rows and rows still prefilling are left bit-identical. The
     step's wall time feeds the (rung, tier) latency table.

A task that serves no tokens (``VisionTask``) runs step 4 as one batched
inference over up to a rung of queued requests instead (``_infer``); its
requests hold no slot and no cache row, and finish in the step that
serves them with ``result`` their predicted class.

Recovery (the reference's DESIGN.md §13): an out-of-memory error at an
admit, a chunk, a decode or an inference (``torch.OutOfMemoryError`` from
the caching allocator, or a ``FaultPlan``'s injected ``serve.step_oom``)
poisons the (rung, tier) pair and steps the rung down, demotes the tier or
sheds a request (``_handle_oom``); a shed request is requeued for a fresh
admission, at most ``max_request_retries`` times, then fails. The
``serve.latency`` fault adds its seconds to a step's recorded time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tu
from repro_torch.core.batch_scaler import BatchScaler
from repro_torch.core.precision import TriAccelConfig
from repro_torch.resilience.faults import (FaultPlan, is_oom_error,
                                           release_failed_attempt,
                                           simulated_oom)
from repro_torch.serve.batching import Request, RequestQueue, pick_rung
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import (LatencyTable, Scheduler,
                                         SchedulerConfig)
from repro_torch.train.serve import as_task


def _pct(xs, q) -> Optional[float]:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None


@dataclasses.dataclass
class ServeConfig:
    prompt_len: int = 16              # fixed prompt length (whole-prompt)
    total_len: int = 48               # cache horizon: prompt + generation
    rungs: Tuple[int, ...] = (2, 4)   # batch rung ladder (ascending)
    tiers: Tuple[int, ...] = (1,)     # decode-weight precision tiers warmed
    ladder: str = "tpu"               # fp8 (tpu) vs fp16 (gpu) low tier
    cache_dtype: Any = torch.bfloat16
    max_new_tokens: int = 16          # per-request default
    t_ctrl: int = 8                   # §3.4 control cadence, decode steps
    mem_cap_bytes: float = 16e9
    auto_tier: bool = True
    seed: int = 0
    # chunked prefill: prompt tokens consumed per admission step; None =
    # whole-prompt admission at the fixed prompt_len. With a chunk size
    # set, prompts are variable length (1..total_len-1)
    prefill_chunk: Optional[int] = None
    schedule: str = "fifo"            # "fifo" | "slo" admission policy
    aging_steps: int = 64             # SLO scheduler: aging, steps a class
    on_infeasible: str = "reject"     # SLO scheduler: "reject" | "degrade"
    # per-priority-class p99 decode-step budget (ms); the latency ceiling
    # stops the rung climbing past the tightest budget of any class present
    latency_slo_ms: Optional[Dict[int, float]] = None
    # OOM-recovery evictions per request before it is failed instead of
    # requeued: a bounded retry turns a crashed session into per-request
    # status="failed"
    max_request_retries: int = 2


class ServeSession:
    """Task-level serving session on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``)."""

    def __init__(self, task, cfg: Optional[ServeConfig] = None, params=None,
                 aux_state=None, tac: Optional[TriAccelConfig] = None,
                 fault_plan: Optional[FaultPlan] = None, device="cuda"):
        cfg = cfg if cfg is not None else ServeConfig()
        if cfg.schedule not in ("fifo", "slo"):
            raise ValueError(f"unknown schedule {cfg.schedule!r} "
                             f"(expected 'fifo' or 'slo')")
        self.device = resolve_device(device)
        self.task = as_task(task, self.device)
        self.cfg = cfg
        if params is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            params, aux_state = self.task.init(gen, device=self.device)
        self.tac = tac if tac is not None else TriAccelConfig(
            ladder=cfg.ladder, mem_cap_bytes=cfg.mem_cap_bytes,
            t_ctrl=cfg.t_ctrl)
        tiers = tuple(sorted(set(cfg.tiers)))
        self.tier = 1 if 1 in tiers else tiers[-1]
        self._tier_locked = not cfg.auto_tier
        self.mm = self.task.serve_memory_model(
            params, cfg.total_len, ladder=cfg.ladder, weight_tier=self.tier)
        self.scaler = BatchScaler(list(cfg.rungs),
                                  self.task.tokens_per_sample(cfg.total_len),
                                  self.mm, self.tac)
        self.engine = ServeEngine(
            self.task, params, aux_state, total_len=cfg.total_len,
            prompt_len=cfg.prompt_len, rungs=cfg.rungs, tiers=tiers,
            ladder=cfg.ladder, cache_dtype=cfg.cache_dtype,
            prefill_chunk=cfg.prefill_chunk, device=self.device)
        del params, aux_state
        self.chunked = self.engine.chunked
        self.rung = cfg.rungs[0]
        self.slots: List[Optional[Request]] = [None] * self.rung
        self.caches = self.engine.init_caches(self.rung)
        if cfg.schedule == "slo":
            self.queue: Any = Scheduler(SchedulerConfig(
                aging_steps=cfg.aging_steps,
                on_infeasible=cfg.on_infeasible))
        else:
            self.queue = RequestQueue()
        self.requests: Dict[int, Request] = {}
        self.steps = 0
        self.decoded_tokens = 0
        self.lat = LatencyTable()
        self.lat_rung: Optional[int] = None
        self.rung_history: List[Tuple[int, int]] = [(0, self.rung)]
        self.tier_history: List[Tuple[int, int]] = [(0, self.tier)]
        self.fault_plan = fault_plan
        #: (step, rung, tier, where) per caught out-of-memory error
        self.oom_events: List[Tuple[int, int, int, str]] = []

    # ------------------------------------------------------------- public --
    @property
    def compile_count(self) -> int:
        return self.engine.compile_count

    def warm(self) -> int:
        """Run every (rung, tier) path once and copy each one's measured
        bytes into the rung controller; returns the paths warmed."""
        n = self.engine.warm()
        self.sync_measured()
        return n

    def sync_measured(self) -> None:
        """Copy the engine's measured bytes into the memory model's (rung,
        tier) overlay. The reference re-harvests its executables' memory
        analysis first; the port's engine measures each path's peak as it
        runs it, so there is nothing to re-harvest."""
        self._refresh_overlay()

    def _refresh_overlay(self) -> None:
        for rung in self.engine.rungs:
            for tier in self.engine.tiers:
                if (rung, tier) in self.mm.poisoned:
                    continue
                mb = self.engine.measured_bytes(rung, tier)
                if mb is not None:
                    self.mm.measured[(rung, tier)] = mb

    def submit(self, inputs: Dict[str, np.ndarray],
               max_new_tokens: Optional[int] = None, priority: int = 1,
               deadline_ms: Optional[float] = None) -> int:
        """Queue one request (unbatched inputs); returns its id.
        ``priority`` (0 = most urgent) and ``deadline_ms`` (completion
        deadline relative to now) drive the SLO scheduler; the FIFO queue
        carries them unused. Invalid requests raise ``ValueError``."""
        n = max_new_tokens if max_new_tokens is not None \
            else self.cfg.max_new_tokens
        if n < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {n}")
        if self.task.serves_tokens:
            tokens = inputs.get("tokens")
            if tokens is None:
                raise ValueError("token-serving request needs 'tokens'")
            p = int(np.asarray(tokens).shape[0])
            if self.chunked:
                if p < 1:
                    raise ValueError("empty prompt")
            elif p != self.cfg.prompt_len:
                raise ValueError(
                    f"prompt length {p} != configured prompt_len "
                    f"{self.cfg.prompt_len} (variable-length prompts need "
                    f"prefill_chunk set)")
            if p + n > self.cfg.total_len:
                raise ValueError(f"prompt {p} + gen {n} exceeds total_len "
                                 f"{self.cfg.total_len}")
        req = self.queue.submit(inputs, max_new_tokens=n, priority=priority,
                                deadline_ms=deadline_ms,
                                submitted_step=self.steps)
        self.requests[req.rid] = req
        return req.rid

    def set_tier(self, tier: int, lock: bool = True):
        """Pin the decode-weight precision tier."""
        if tier not in self.engine.tiers:
            raise ValueError(f"tier {tier} not warmed "
                             f"(configured: {self.engine.tiers})")
        if tier != self.tier:
            self.tier_history.append((self.steps, tier))
        self.tier = tier
        self._tier_locked = lock

    def step(self):
        if self.steps % self.tac.t_ctrl == 0:
            self._control()
        self._resize()
        if self.task.serves_tokens:
            self._admit()
            self._decode()
        else:
            self._infer()
        self.steps += 1

    def run(self, max_steps: int = 10_000) -> Dict[str, Any]:
        """Step until the queue drains and every request completes.
        ``warm_s`` is the wall time of the paths that first ran inside the
        loop (``ServeEngine.compile_s``: none after ``warm()``), and
        ``serve_s`` = ``wall_s`` - ``warm_s`` prices the serving itself."""
        t0 = time.time()
        c0 = self.engine.compile_s
        while (len(self.queue) or self._active()) and self.steps < max_steps:
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = max(time.time() - t0, 1e-9)
        warm_s = self.engine.compile_s - c0
        serve_s = max(dt - warm_s, 1e-9)
        return {"steps": self.steps, "decoded_tokens": self.decoded_tokens,
                "wall_s": dt, "warm_s": warm_s, "serve_s": serve_s,
                "tok_s": self.decoded_tokens / serve_s,
                "rung_history": list(self.rung_history),
                "tier_history": list(self.tier_history),
                "compile_count": self.compile_count,
                **self.latency_report()}

    def latency_report(self) -> Dict[str, Any]:
        """Queue wait (steps) and time-to-first-token (wall seconds)
        percentiles over everything admitted so far."""
        reqs = list(self.requests.values())
        queue_steps = [r.admitted_step - r.submitted_step for r in reqs
                       if r.admitted_step >= 0 and r.submitted_step >= 0]
        ttft = [r.first_token_time - r.submit_time for r in reqs
                if r.first_token_step >= 0]
        return {
            "queue_steps_p50": _pct(queue_steps, 50),
            "queue_steps_p99": _pct(queue_steps, 99),
            "ttft_s_p50": _pct(ttft, 50),
            "ttft_s_p99": _pct(ttft, 99),
            "rejected": sum(r.status == "rejected" for r in reqs),
            "failed": sum(r.status == "failed" for r in reqs),
        }

    def results(self) -> Dict[int, Request]:
        return dict(self.requests)

    # ----------------------------------------------------------- internals --
    def _active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def _classes_present(self) -> List[int]:
        """Priority classes with work in the session (queued or slotted)."""
        classes = {r.priority for r in self._active()}
        classes.update(self.queue.depth_by_class())
        return sorted(classes)

    def _step_budget_s(self) -> Optional[float]:
        """Tightest per-step p99 budget among the classes present."""
        slo = self.cfg.latency_slo_ms
        if not slo:
            return None
        budgets = [slo[c] for c in self._classes_present() if c in slo]
        return min(budgets) / 1e3 if budgets else None

    def _control(self):
        """§3.3/§3.4 serve-side control: the memory-capacity rung, the
        latency ceiling and the decode-weight tier, measured-first."""
        self.mm.weight_tier = self.tier
        self._refresh_overlay()
        self.lat_rung = self.lat.latency_rung(
            self.engine.rungs, self.tier, self._step_budget_s())
        self.scaler.observe(self.steps, measured_bytes=self.mm.measured.get(
            (self.scaler.microbatch, self.tier)), rung_cap=self.lat_rung)
        if self._tier_locked or len(self.engine.tiers) < 2:
            return
        cap = self.tac.rho_high * self.tac.mem_cap_bytes
        tokens = self.rung * self.task.tokens_per_sample(self.cfg.total_len)
        usable = [t for t in sorted(self.engine.tiers, reverse=True)
                  if (self.rung, t) not in self.mm.poisoned]
        chosen = None
        for tier in usable:
            self.mm.weight_tier = tier
            if self.mm.predict(self.rung, tokens) <= cap:
                chosen = tier
                break
        if chosen is None:
            chosen = usable[-1] if usable else self.tier
        self.mm.weight_tier = chosen
        if chosen != self.tier:
            self.tier = chosen
            self.tier_history.append((self.steps, chosen))

    def _resize(self):
        active = self._active()
        target = pick_rung(self.engine.rungs, len(active), len(self.queue),
                           self.scaler.microbatch, latency_rung=self.lat_rung)
        if target != self.rung:
            self._move_to(target, active)

    def _move_to(self, target: int, active: List[Request]):
        """Re-batch onto rung ``target``: the ``active`` requests' cache rows
        move to slots 0.. in order through the repack (a task without a
        cache has no rows to move)."""
        if self.caches is not None:
            src = np.zeros((target,), np.int64)
            valid = np.zeros((target,), bool)
            for j, req in enumerate(active):
                src[j], valid[j] = req.slot, True
            self.caches = self.engine.repack(self.rung, target, self.caches,
                                             src, valid)
        self.slots = list(active) + [None] * (target - len(active))
        for j, req in enumerate(active):
            req.slot = j
        self.rung = target
        self.rung_history.append((self.steps, target))

    def _finish(self, req: Request, status: str = "done"):
        req.status = status
        req.finished_step = self.steps
        req.finish_time = time.time()
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None

    # ------------------------------------------------------ OOM recovery --
    def _fail(self, req: Request):
        """Terminal per-request failure, the bounded retry's end: the
        session keeps serving and the caller reads status='failed'."""
        self._finish(req, "failed")

    def _shed(self, req: Request):
        """Evict ``req`` for OOM recovery: free its slot and requeue it for
        a fresh admission (the prefill replays, deterministically: same
        prompt, same weights), or fail it once its retries exceed
        ``cfg.max_request_retries``."""
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None
        self.decoded_tokens -= len(req.tokens)   # the replay counts them
        req.tokens = []
        req.index = 0
        req.prefill_pos = 0
        req.admitted_step = -1
        req.first_token_step = -1
        req.first_token_time = 0.0
        req.retries += 1
        if req.retries > self.cfg.max_request_retries:
            self._fail(req)
        else:
            self.queue.requeue(req)

    def _handle_oom(self, where: str):
        """Serve-side OOM recovery: poison the (rung, tier) pair in the
        measured overlay (never entered again: ``BatchScaler.mark_oom``),
        then free memory in place: step down to the largest smaller rung
        (shedding the requests admitted last until the rest fit, their
        cache rows moved by the repack), or, at the smallest rung, demote
        to the highest unpoisoned lower tier, or else shed the youngest
        request. The failed dispatch is retried on the next ``step()``.

        The retry is bitwise what it would have been after an injected
        fault. A failed admit's request is shed, so its row is rewritten
        whole at its next admission. A decode writes each valid row's slot
        ``index % L`` layer by layer, so one that fails after layer k has
        written that slot in layers < k; the retry writes the same slots
        with the same keys, values and positions before any layer reads
        them (``ServeEngine.decode`` restores the invalid rows'). A failed
        chunk's request is shed too, and its next first chunk clears the
        row. Caches that are no longer whole (``_caches_alive``) are
        rebuilt empty and every slotted request replays; a task without a
        cache has none to move."""
        self.oom_events.append((self.steps, self.rung, self.tier, where))
        self.mm.weight_tier = self.tier
        self.scaler.mark_oom(self.rung)
        if not self._caches_alive():
            self.caches = self.engine.init_caches(self.rung)
            for req in self._active():
                self._shed(req)
        active = self._active()
        smaller = [r for r in self.engine.rungs if r < self.rung]
        def youngest():
            return max(active, key=lambda r: (r.admitted_step, r.slot or 0))
        if smaller:
            target = max(smaller)
            while len(active) > target:
                victim = youngest()
                self._shed(victim)
                active.remove(victim)
            self._move_to(target, active)
            return
        lower = [t for t in self.engine.tiers if t < self.tier
                 and (self.rung, t) not in self.mm.poisoned]
        if lower:
            self.set_tier(max(lower), lock=self._tier_locked)
            return
        if active:    # smallest rung, lowest tier: shed the youngest
            self._shed(youngest())

    def _caches_alive(self) -> bool:
        """Whether a token task's caches hold a row for every slot. The
        reference rebuilds caches whose donated buffers a failed dispatch
        consumed; here every path writes them in place and none consumes
        them, so only missing caches, or caches at another rung than the
        slot array, count as dead."""
        if not self.task.serves_tokens:
            return True
        return self.caches is not None and all(
            c.shape[1] == self.rung for c in tu.leaves(self.caches))

    def _step_oom(self, site: str):
        """Raise the ``serve.step_oom`` fault scheduled for this step."""
        if self.fault_plan is not None and self.fault_plan.fires(
                "serve.step_oom", self.steps, rung=self.rung, tier=self.tier):
            raise simulated_oom(site, self.steps)

    def _first_token(self, req: Request, tok0: int):
        req.tokens = [int(tok0)]
        req.first_token_step = self.steps
        req.first_token_time = time.time()
        self.decoded_tokens += 1
        if len(req.tokens) >= req.max_new_tokens:
            self._finish(req)

    def _pop_next(self) -> Optional[Request]:
        """Next request in scheduler order, priced with the measured
        latency estimates (the SLO scheduler's deadline-feasibility check;
        the FIFO queue ignores them): a step's p50 at the current (rung,
        tier) per decode step, and per chunk of the prompt when chunked."""
        p50 = self.lat.p50(self.rung, self.tier)
        est_step_ms = (p50 or 0.0) * 1e3
        chunk = self.cfg.prefill_chunk or self.cfg.prompt_len

        def admit_ms(req: Request) -> float:
            chunks = -(-max(req.prompt_len, 1) // chunk) if self.chunked else 1
            return est_step_ms * chunks
        return self.queue.pop(now_step=self.steps, est_step_ms=est_step_ms,
                              est_admit_ms=admit_ms)

    def _admit(self):
        # advance the chunked prefills in flight: one chunk per request per
        # step, so long prompts interleave with the decodes below
        if self.chunked:
            for req in list(self.slots):
                if req is not None and req.status == "prefilling":
                    if not self._chunk_step(req):
                        return               # OOM: recovery ran this step
        for s in range(self.rung):
            if self.slots[s] is not None or not len(self.queue):
                continue
            req = self._pop_next()
            if req is None:          # everything left was rejected (SLO)
                break
            req.slot = s
            req.admitted_step = self.steps
            self.slots[s] = req
            if self.chunked:
                req.status = "prefilling"
                if not self._chunk_step(req):   # its first chunk lands now
                    return                      # OOM: recovery ran
                continue
            try:
                self._step_oom("serve.admit")
                batch1 = {k: v[None] for k, v in req.inputs.items()}
                tok0, self.caches = self.engine.admit(self.rung, self.tier,
                                                      self.caches, s, batch1)
                tok0 = int(tok0)                  # reads the token: syncs
            except Exception as e:   # noqa: BLE001 — filtered below
                if not is_oom_error(e):
                    raise
                release_failed_attempt(e, self.device)
                self._shed(req)
                self._handle_oom("admit")
                return
            req.status = "active"
            req.index = self.cfg.prompt_len
            self._first_token(req, tok0)

    def _chunk_step(self, req: Request) -> bool:
        """Feed the next prefill chunk of ``req`` (padded to the chunk
        size; the engine runs its real lanes). The final chunk gives the
        request's first token and makes it active at index = prompt
        length. Returns False when the dispatch ran out of memory (the
        request was shed and recovery ran; the caller stops admitting this
        step)."""
        C = self.cfg.prefill_chunk
        P = req.prompt_len
        f = req.prefill_pos
        n = min(C, P - f)
        chunk = np.zeros((C,), np.int32)
        chunk[:n] = np.asarray(req.inputs["tokens"][f:f + n], np.int32)
        try:
            self._step_oom("serve.chunk")
            tok0, self.caches = self.engine.chunk_admit(
                self.rung, self.tier, self.caches, req.slot, chunk, f, n,
                f == 0)
            # the final chunk reads its token (a sync); others run on
            tok0 = int(tok0) if f + n >= P else None
        except Exception as e:   # noqa: BLE001 — filtered below
            if not is_oom_error(e):
                raise
            release_failed_attempt(e, self.device)
            self._shed(req)
            self._handle_oom("chunk")
            return False
        req.prefill_pos = f + n
        if req.prefill_pos >= P:
            req.status = "active"
            req.index = P
            self._first_token(req, tok0)
        return True

    def _decode(self):
        if not any(r is not None and r.status == "active"
                   for r in self.slots):
            return
        tokens = np.zeros((self.rung,), np.int32)
        index = np.zeros((self.rung,), np.int32)
        valid = np.zeros((self.rung,), bool)
        for s, req in enumerate(self.slots):
            if req is not None and req.status == "active":
                tokens[s], index[s], valid[s] = req.tokens[-1], req.index, True
        t0 = time.time()
        try:
            self._step_oom("serve.decode")
            out, self.caches = self.engine.decode(self.rung, self.tier,
                                                  self.caches, tokens, index,
                                                  valid)
            out = out.cpu().numpy()  # waits for the step: its real wall time
        except Exception as e:       # noqa: BLE001 — filtered below
            if not is_oom_error(e):
                raise
            release_failed_attempt(e, self.device)
            # no token landed and the positions are unchanged: the next
            # step() retries this decode at the stepped-down (rung, tier)
            self._handle_oom("decode")
            return
        dt = time.time() - t0
        if self.fault_plan is not None:
            spike = self.fault_plan.fires("serve.latency", self.steps,
                                          rung=self.rung, tier=self.tier)
            if spike is not None:
                dt += spike.seconds    # as if the step really stalled
        self.lat.record(self.rung, self.tier, dt)
        for s, req in enumerate(list(self.slots)):
            if req is None or req.status != "active":
                continue
            req.index += 1
            if len(req.tokens) < req.max_new_tokens:
                req.tokens.append(int(out[s]))
                self.decoded_tokens += 1
            if len(req.tokens) >= req.max_new_tokens:
                self._finish(req)

    def _infer(self):
        """One batched inference over up to a rung of queued requests (a
        task that serves no tokens): each finishes in this step with
        ``result`` its predicted class. The batch is padded to the rung
        with zero images; on an OOM its requests, which hold no slot, are
        shed and recovery runs."""
        batch_reqs: List[Request] = []
        while len(self.queue) and len(batch_reqs) < self.rung:
            req = self._pop_next()
            if req is None:
                break
            batch_reqs.append(req)
        if not batch_reqs:
            return
        key = next(iter(self.engine.input_spec))
        shape = tuple(self.engine.input_spec[key].shape[1:])
        images = np.zeros((self.rung,) + shape, np.float32)
        for j, req in enumerate(batch_reqs):
            images[j] = np.asarray(req.inputs[key], np.float32)
        t0 = time.time()
        try:
            self._step_oom("serve.infer")
            preds, _ = self.engine.infer(self.rung, self.tier, {key: images})
            preds = preds.cpu().numpy()   # waits: the step's real wall time
        except Exception as e:     # noqa: BLE001 — filtered below
            if not is_oom_error(e):
                raise
            release_failed_attempt(e, self.device)
            for req in batch_reqs:
                self._shed(req)
            self._handle_oom("infer")
            return
        dt = time.time() - t0
        if self.fault_plan is not None:
            spike = self.fault_plan.fires("serve.latency", self.steps,
                                          rung=self.rung, tier=self.tier)
            if spike is not None:
                dt += spike.seconds
        self.lat.record(self.rung, self.tier, dt)
        for j, req in enumerate(batch_reqs):
            req.status = "active"
            req.admitted_step = self.steps
            req.result = int(preds[j])
            req.first_token_step = self.steps
            req.first_token_time = time.time()
            self._finish(req)
