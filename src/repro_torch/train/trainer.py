"""Host-side training engine: the Tri-Accel control cadence around the
train step, on one device.

  * every step: the train step (``train_step.make_train_step``) — the
    slab-resident fused step, or ``reference_step`` over tree-form state
    when the update is not fused (the FP32 and static-AMP baselines);
  * every ``t_curv`` steps: the §3.2 curvature refresh on a small batch
    (``fisher``, or one Hutchinson probe for ``hutchinson`` and ``power``,
    as the reference);
  * every ``t_ctrl`` steps: the §3.3 rung controller, fed the peak bytes
    measured around each rung's first step (``torch.cuda`` allocator
    statistics; the analytic model answers on the CPU);
  * every ``ckpt_every`` steps (with ``ckpt_dir``): an async checkpoint
    of the tree-form state in the reference's format
    (``repro_torch.checkpoint``), and a blocking one at the end of ``run``;
  * on SIGTERM or SIGINT (``install_preemption_handler``): a blocking
    checkpoint at the top of the next step, then ``SystemExit(143)``;
    ``maybe_restore`` resumes from the newest generation that verifies,
    whichever package wrote it;
  * on ``torch.OutOfMemoryError`` (the caching allocator's, or a fault
    plan's injected one; ``resilience.is_oom_error``): poison the rung,
    step down and re-run the same batch (data is a pure function of
    (seed, step)), at most ``recovery.max_oom_retries`` times; a blocking
    checkpoint before an OOM on the smallest rung re-raises;
  * with ``recovery.watchdog``: the divergence watchdog reads each step's
    loss and ``grads_finite`` (one host read a step) and, on a run of
    non-finite steps or a loss spike, rolls back to the newest committed
    generation with the loss scale and ``ControlState.lr_demote``
    demoted; the checkpoint cadence holds while suspect steps are in
    flight;
  * with ``fault_plan`` (``resilience.FaultPlan``): the reference's
    trainer fault sites, ``train.step_oom``, ``train.nonfinite``,
    ``train.sigterm`` and ``ckpt.corrupt``.

PyTorch runs eagerly, so the reference's AOT executable cache has no
counterpart, and nothing donates the state: a failed dispatch leaves it
intact for the retry.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as tu
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_step, manifest_keys,
                                               restore_checkpoint)
from repro_torch.core import curvature as curv
from repro_torch.core.batch_scaler import BatchScaler, measured_peak_bytes
from repro_torch.core.controller import init_control, with_curvature
from repro_torch.core.precision import TriAccelConfig
from repro_torch.kernels.layout import slab_view
from repro_torch.optim.optimizers import adamw, sgdm
from repro_torch.resilience.faults import (FaultPlan, corrupt_checkpoint,
                                           is_oom_error,
                                           release_failed_attempt,
                                           simulated_oom)
from repro_torch.resilience.recovery import (DivergenceError,
                                             DivergenceWatchdog,
                                             RecoveryConfig)
from repro_torch.train.schedules import warmup_cosine
from repro_torch.kernels.fused_update import seed_compute
from repro_torch.train.train_step import (TrainState, _cast_codes,
                                          init_compute, make_train_step,
                                          pack_state, resolve_fused,
                                          unpack_state)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 200
    base_lr: float = 3e-3
    warmup_steps: int = 20
    optimizer: str = "sgdm"
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    accum: int = 1
    seed: int = 0
    seq_len: int = 128
    rungs: tuple = (8,)
    start_rung: Optional[int] = None  # None: largest rung that fits
    #: checkpoints (the reference's format) go here; None: no checkpoints
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    b_curv: int = 4
    elastic_true_batch: bool = True   # paper mode: rung changes global B
    fused_update: Optional[bool] = None
    #: recovery supervision: the OOM retry budget, the divergence
    #: watchdog, the rollback demotions
    recovery: RecoveryConfig = dataclasses.field(
        default_factory=RecoveryConfig)


def set_f32_numerics(device: torch.device) -> None:
    """Full f32 for convolutions and matmuls on the card, as the reference
    computes: cuDNN would otherwise run f32 convolutions in TF32."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


class Trainer:
    """The Tri-Accel engine for a task (``VisionTask`` or ``LMTask``) on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``; it must
    be the task's)."""

    def __init__(self, task, tac: TriAccelConfig, tcfg: TrainerConfig,
                 device="cuda", fault_plan: Optional[FaultPlan] = None):
        self.device = resolve_device(device)
        if task.device != self.device:
            raise ValueError(f"task lives on {task.device}, trainer asked "
                             f"for {self.device}")
        set_f32_numerics(self.device)
        self.task, self.cfg, self.tac, self.tcfg = task, task.cfg, tac, tcfg
        gen = torch.Generator().manual_seed(tcfg.seed)
        params, aux_state = task.init(gen)
        self.grouping = task.grouping(params)
        opt = (sgdm(tcfg.momentum, tcfg.weight_decay)
               if tcfg.optimizer == "sgdm"
               else adamw(weight_decay=tcfg.weight_decay))
        self.opt = opt
        schedule = warmup_cosine(tcfg.base_lr, tcfg.warmup_steps,
                                 tcfg.total_steps)
        self.fused = (tcfg.fused_update if tcfg.fused_update is not None
                      else resolve_fused(opt, tac))
        # slab residency: master, moments and compute copy live as (rows,
        # 512) slabs across steps whenever the step is fused (it needs an
        # all-floating params tree); the reference path keeps the tree
        self.resident = self.fused and all(
            l.dtype.is_floating_point for l in tu.leaves(params))
        if self.fused and not self.resident:
            raise NotImplementedError(
                "the tree-form fused_step (a params tree with non-floating "
                "leaves) is not ported (ROADMAP A6)")
        self._params_like = tu.tree_map(
            lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
            params)
        self.view = (slab_view(params, self.grouping) if self.resident
                     else None)
        self._step_fn = make_train_step(
            task, tac, opt, self.grouping, schedule, accum=tcfg.accum,
            grad_clip=tcfg.grad_clip, fused_update=self.fused,
            resident_params=self._params_like if self.resident else None,
            donate=self.resident)
        control = init_control(self.grouping.num_layers, tac, self.device)
        if self.resident:
            leaves, params = tu.leaves(params), None
            self.state = self._resident_state(leaves, aux_state, control)
        else:
            self.state = TrainState(params, aux_state, opt.init(params),
                                    control, ())

        mm = task.memory_model(self._params_like, opt_slots=opt.slots)
        self.scaler = BatchScaler(tcfg.rungs,
                                  task.tokens_per_sample(tcfg.seq_len), mm,
                                  tac, start_rung=tcfg.start_rung)
        self.stream = task.data_stream(self.scaler.microbatch,
                                       seed=tcfg.seed, seq_len=tcfg.seq_len)
        #: rung -> peak bytes measured around the rung's first step (cuda)
        self.measured_bytes: Dict[int, float] = {}
        self.ckpt = (AsyncCheckpointer(tcfg.ckpt_dir, tcfg.ckpt_keep)
                     if tcfg.ckpt_dir else None)
        self._preempted = False
        self.metrics_log: List[Dict[str, Any]] = []
        # recovery supervision
        self.fault_plan = fault_plan
        self._watchdog = (DivergenceWatchdog(tcfg.recovery)
                          if tcfg.recovery.watchdog else None)
        self.oom_events: list = []       # (step, rung) per caught OOM
        self.rollback_events: list = []  # (diverged_step, restored_step)

    def _state_versions(self) -> list:
        """The version counters of the state's tensors: an in-place write
        (the donated apply's) moves them."""
        return [t._version for t in tu.leaves(self.state)
                if isinstance(t, torch.Tensor)]

    def _resident_state(self, leaves: list, aux_state, control
                        ) -> TrainState:
        """The slab-resident state from the params tree's flat ``leaves``
        (emptied here), equal to ``pack_state`` of the tree-form one but
        built without a second copy of the model: the master slab first
        (each leaf goes once packed), then the compute copy and the
        per-layer absmax from it (``seed_compute`` on the slab), the
        moments as zero slabs. A 4 B-parameter model's tree (16 GB in
        f32) beside its slabs and the tree-form moments and copy would not
        fit one card."""
        p_slab = self.view.pack_consuming(leaves, torch.float32)
        compute = seed_compute(
            self.view, p_slab, _cast_codes(self.task, self.grouping,
                                           control.codes),
            self.tac.ladder, self.task.compute_dtype, slab=True)
        opt_state = self.opt.init(p_slab)
        return TrainState(p_slab, aux_state, opt_state, control, compute)

    # ------------------------------------------------------------- utils --
    def params_tree(self):
        """f32 master params in TREE form (on the resident path, views of
        the master slab) — the eval/export boundary."""
        if not self.resident:
            return self.state.params
        return self.view.unpack(self.state.params, like=self._params_like)

    def serving_amax_tree(self):
        """Per-leaf absmax of the live master weights, from the fused
        step's carried per-layer table (the max over a leaf's layers of the
        container-cast master): hand it to ``ServeEngine(amax_tree=...)``
        or ``tier_params`` so the tier-0 cast takes the one-pass form. None
        on the reference path (the cast then finds its own absmax). The
        fused path is always slab-resident here: the tree-form fused step
        is not ported, and ``__init__`` refuses it."""
        if not self.fused:
            return None
        return self.view.amax_tree(self.state.compute["p_amax"],
                                   self._params_like)

    def _save_state(self) -> TrainState:
        """Checkpoint boundary: resident slabs unpack to TREE form (views
        of the slabs; the checkpointer copies them to the host before the
        next step), so checkpoints stay residency-agnostic and match the
        reference's."""
        if not self.resident:
            return self.state
        return unpack_state(self.view, self.state, self._params_like)

    def _tree_template(self) -> TrainState:
        """Tree-form state matching what ``_save_state`` writes, on the
        meta device where the leaves are parameter-shaped: the restore
        template of a resident trainer (only its key paths are read)."""
        cd = self.task.compute_dtype
        compute = {"p_amax": torch.empty((self.grouping.num_layers,),
                                         device="meta"),
                   "tree": tu.tree_map(lambda p: torch.empty(
                       p.shape, dtype=cd, device="meta"), self._params_like)}
        return TrainState(self._params_like, self.state.aux_state,
                          self.opt.init(self._params_like),
                          self.state.control, compute)

    def _batch_for_rung(self, rung: int, step: int):
        stream = dataclasses.replace(self.stream, global_batch=rung) \
            if self.tcfg.elastic_true_batch else self.stream
        return stream.batch(step)

    # ------------------------------------------------- fault tolerance ----
    def install_preemption_handler(self):
        """Checkpoint-and-exit on SIGTERM (spot reclamation) and SIGINT
        (Ctrl-C). Prior handlers are chained, not clobbered; SIG_DFL,
        SIG_IGN and Python's default SIGINT handler (whose KeyboardInterrupt
        would defeat the graceful exit) are not chained."""
        def _make(prev):
            chain = prev if (callable(prev)
                             and prev is not signal.default_int_handler) \
                else None

            def _handler(signum, frame):
                self._preempted = True
                if chain is not None:
                    chain(signum, frame)
            return _handler

        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _make(signal.getsignal(sig)))

    @staticmethod
    def _fill_missing():
        """Fills for leaves newer than the checkpoint on disk: a
        checkpoint without the rollback demotion restores at 1.0."""
        return {"lr_demote": np.ones((), np.float32)}

    def maybe_restore(self) -> int:
        """Restore the newest committed generation of ``ckpt_dir`` that
        verifies, written by this package or the reference, onto this
        trainer's device -> the restored ``control.step`` (0 when there is
        none)."""
        if not (self.tcfg.ckpt_dir
                and latest_step(self.tcfg.ckpt_dir) is not None):
            return 0
        if self.resident:
            return self._restore_resident()
        self.state = restore_checkpoint(self.tcfg.ckpt_dir, self.state,
                                        device=self.device,
                                        fill_missing=self._fill_missing())
        return int(self.state.control.step)

    def _restore_resident(self) -> int:
        """Restore a tree-form checkpoint into the slab-resident trainer:
        leaves load onto this device and pack into slabs. Takes 5-field
        states (what ``_save_state`` writes) and 4-field ones (a
        reference-path run's: ``compute`` re-seeded from the restored
        masters)."""
        keys = manifest_keys(self.tcfg.ckpt_dir)
        has_compute = any(k.startswith(".compute") for k in keys)
        tmpl = self._tree_template()
        if not has_compute:
            tmpl = tmpl._replace(compute=())
        host = restore_checkpoint(self.tcfg.ckpt_dir, tmpl,
                                  device=self.device,
                                  fill_missing=self._fill_missing())
        if not has_compute:
            host = host._replace(compute=init_compute(
                self.task, host.params, self.grouping, host.control,
                self.tac))
        self.state = pack_state(self.view, host, self.task.compute_dtype)
        return int(self.state.control.step)

    # -------------------------------------------------------------- run ---
    def run(self, steps: Optional[int] = None):
        """Take ``steps`` steps (``total_steps`` by default) from the
        state's ``control.step``. A rollback sends the loop back to the
        restored step and leaves the end where it was."""
        steps = steps if steps is not None else self.tcfg.total_steps
        start = int(self.state.control.step)
        end = start + steps
        t0 = time.time()
        step = start
        while step < end:
            if self.fault_plan is not None and \
                    self.fault_plan.fires("train.sigterm", step):
                self._deliver_sigterm()
            if self._preempted:
                if self.ckpt:
                    self.ckpt.save(step, self._save_state(), block=True)
                    self._maybe_corrupt(step)
                raise SystemExit(143)
            if self.fault_plan is not None:
                self._inject_nonfinite(step)
            self.state, metrics, rung = self._dispatch(step)

            # §3.2 curvature cadence (host side, tiny batch)
            if self.tac.enable_curvature and step > 0 and \
                    step % self.tac.t_curv == 0:
                lam = self._curvature(step)
                self.state = self.state._replace(
                    control=with_curvature(self.state.control, lam))
            # §3.3 batch-rung cadence: measured-first, analytic fallback
            if step > 0 and step % self.tac.t_ctrl == 0:
                codes = self.state.control.codes.tolist()
                self.scaler.observe(step, codes=codes,
                                    measured_bytes=self.measured_bytes.get(
                                        rung))
            # checkpoint cadence: the generation is named ``step`` and
            # holds control.step == step + 1, as the reference's; held
            # while the watchdog has suspect steps in flight, so that a
            # mid-burst state never displaces the clean generation a
            # rollback needs
            if self.ckpt and step > 0 and step % self.tcfg.ckpt_every == 0 \
                    and (self._watchdog is None or self._watchdog.healthy):
                self.ckpt.save(step, self._save_state())
                self._maybe_corrupt(step)
            if step % self.tcfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, rung=rung,
                         mem_gb=self.scaler._mem(self.scaler.idx) / 1e9,
                         wall_s=round(time.time() - t0, 4))
                self.metrics_log.append(m)
            if self._watchdog is not None:
                loss, finite = torch.stack(
                    [metrics["loss"].float(),
                     metrics["grads_finite"].float()]).tolist()
                if self._watchdog.observe(loss, bool(finite)):
                    step = self._rollback(step)
                    continue
            step += 1
        if self.ckpt:
            self.ckpt.save(end, self._save_state(), block=True)
            self._maybe_corrupt(end)
        return self.metrics_log

    # ---------------------------------------------------------- recovery --
    def _dispatch(self, step: int):
        """One train step with OOM step-down: an out-of-memory error
        (``is_oom_error``: the allocator's ``torch.OutOfMemoryError``, or
        the ``train.step_oom`` fault's) poisons the rung
        (``BatchScaler.mark_oom``), steps down and re-runs the SAME batch,
        at most ``recovery.max_oom_retries`` times; an OOM on the smallest
        rung re-raises after a blocking checkpoint. Every other error
        propagates at once. Before the retry, ``release_failed_attempt``
        frees the failed attempt's frames and the allocator's cached blocks,
        so that the retry's convolutions run the algorithms a fresh run's
        do.

        The resident step donates its slabs, as the reference's jitted
        step does: the fused apply writes the new master, moments and
        compute copy over them. It is the step's last allocation of any
        size, so an out-of-memory error (real, or the fault's, raised
        before the step) lands before it and the state is intact for the
        retry and the rescue checkpoint. Where a failed attempt did write
        over its state (the slabs' version counters moved), the error
        re-raises at once with no rescue checkpoint, as the reference's
        ``_state_alive`` check does."""
        err: Optional[BaseException] = None
        for _ in range(self.tcfg.recovery.max_oom_retries + 1):
            rung = self.scaler.microbatch
            versions = self._state_versions()
            try:
                if self.fault_plan is not None and self.fault_plan.fires(
                        "train.step_oom", step, rung=rung):
                    raise simulated_oom("train.step_oom", step, rung)
                batch = self._batch_for_rung(rung, step)
                if rung in self.measured_bytes or \
                        self.device.type != "cuda":
                    state, metrics = self._step_fn(self.state, batch)
                else:
                    (state, metrics), peak = measured_peak_bytes(
                        lambda: self._step_fn(self.state, batch),
                        self.device)
                    self.measured_bytes[rung] = peak
                    self.scaler.model.record_measured(
                        rung, peak, rung * self.scaler.seq_len,
                        ladder=self.tac.ladder)
                return state, metrics, rung
            except Exception as e:          # noqa: BLE001 — filtered below
                if not is_oom_error(e):
                    raise
                release_failed_attempt(e, self.device)
                err = e
                self.oom_events.append((step, rung))
                if self._state_versions() != versions:
                    # the failed attempt wrote over its donated state:
                    # nothing to retry with; restart from the last
                    # checkpoint, as the reference's _state_alive
                    raise
                if self.scaler.mark_oom(rung) == rung:
                    break                   # smallest rung OOM'd: escalate
        if self.ckpt:
            self.ckpt.save(step, self._save_state(), block=True)
        raise err

    def _rollback(self, step: int) -> int:
        """Divergence rollback: restore the newest committed generation
        that verifies and apply the deterministic demotion, the loss scale
        down (floored at 1.0 on the gpu ladder) and ``ControlState
        .lr_demote`` down, so that the replay is not a bitwise rerun into
        the same blow-up. Returns the restored step (the loop resumes
        there); bounded by ``recovery.max_rollbacks``."""
        rec = self.tcfg.recovery
        if self.ckpt:
            self.ckpt.wait()    # never race an in-flight save
        if not (self.tcfg.ckpt_dir
                and latest_step(self.tcfg.ckpt_dir) is not None):
            raise DivergenceError(
                f"diverged at step {step} with no committed checkpoint "
                f"to roll back to")
        if len(self.rollback_events) >= rec.max_rollbacks:
            raise DivergenceError(
                f"diverged at step {step}: rollback budget "
                f"({rec.max_rollbacks}) exhausted")
        restored = self.maybe_restore()
        ctrl = self.state.control
        f32 = dict(dtype=torch.float32, device=self.device)
        ls = torch.as_tensor(ctrl.loss_scale, **f32) * rec.loss_scale_demotion
        if self.tac.ladder == "gpu":
            ls = torch.clamp_min(ls, 1.0)
        demote = torch.as_tensor(ctrl.lr_demote, **f32) * rec.lr_demotion
        self.state = self.state._replace(control=ctrl._replace(
            loss_scale=ls, lr_demote=demote))
        self._watchdog.reset()
        self.rollback_events.append((step, restored))
        return restored

    def _inject_nonfinite(self, step: int):
        """train.nonfinite fault: force the carried loss scale to inf so
        this step's gradient overflows through the real finite gate (the
        step skips its update, ``grads_finite`` is 0). The gpu ladder's
        overflow rule then halves the scale and caps it at 2^24, so a
        burst re-fires each step; recovery is the watchdog's rollback, as
        for an organic divergence."""
        if self.fault_plan.fires("train.nonfinite", step) is None:
            return
        ctrl = self.state.control
        bad = torch.full((), float("inf"), dtype=torch.float32,
                         device=self.device)
        self.state = self.state._replace(
            control=ctrl._replace(loss_scale=bad))

    def _deliver_sigterm(self):
        """train.sigterm fault: deliver a real signal to the process so the
        chained preemption handlers run, then wait for the flag (CPython
        runs handlers at the next bytecode boundary)."""
        signal.raise_signal(signal.SIGTERM)
        for _ in range(1000):
            if self._preempted:
                return
            time.sleep(0.001)
        self._preempted = True    # handler not installed: honor the fault

    def _maybe_corrupt(self, step: int):
        """ckpt.corrupt fault: damage the generation just committed (after
        waiting out the background writer: the fault models storage
        tearing a completed commit, which verification and the restore's
        fallback must survive)."""
        if self.fault_plan is None:
            return
        f = self.fault_plan.fires("ckpt.corrupt", step)
        if f is None:
            return
        self.ckpt.wait()
        corrupt_checkpoint(self.tcfg.ckpt_dir, f.kind, self.fault_plan.rng)

    def _curvature(self, step: int):
        """The §3.2 refresh on ``b_curv`` samples of this step's batch:
        ``fisher``, or else (``hutchinson``, and ``power`` as the reference
        sends it) the per-layer Hutchinson traces from one probe drawn
        from a generator seeded with ``step``."""
        mb = self.stream.batch(step)
        small = {k: v[:self.tcfg.b_curv] for k, v in mb.items()}
        aux = self.state.aux_state
        params = self.params_tree()          # eval boundary: one unpack
        loss_fn = lambda p, b: self.task.curvature_loss(p, aux, b)  # noqa
        if self.tac.curvature_method == "fisher":
            leaves, treedef = tu.flatten(params)
            leaves = [l.detach().requires_grad_(True) for l in leaves]
            loss = loss_fn(tu.unflatten(treedef, leaves), small)
            grads = torch.autograd.grad(loss, leaves)
            return curv.fisher_layer(tu.unflatten(treedef, list(grads)),
                                     self.grouping.mean)
        gen = torch.Generator().manual_seed(step)
        return curv.hutchinson_layer_traces(loss_fn, params,
                                            self.grouping.mean, gen, 1,
                                            small)
