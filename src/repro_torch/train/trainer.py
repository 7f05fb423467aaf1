"""Host-side training engine: the Tri-Accel control cadence around the
train step, on one device.

  * every step: the train step (``train_step.make_train_step``) — the
    slab-resident fused step, or ``reference_step`` over tree-form state
    when the update is not fused (the FP32 and static-AMP baselines);
  * every ``t_curv`` steps: the §3.2 fisher curvature refresh on a small
    batch;
  * every ``t_ctrl`` steps: the §3.3 rung controller, fed the peak bytes
    measured around each rung's first step (``torch.cuda`` allocator
    statistics; the analytic model answers on the CPU);
  * on ``torch.cuda.OutOfMemoryError``: poison the rung, step down and
    re-run the same batch (data is a pure function of (seed, step)).

PyTorch runs eagerly, so the reference's AOT executable cache has no
counterpart. Checkpointing, fault plans and the divergence watchdog are not
ported yet and raise when configured.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch import tree as tu
from repro_torch.core import curvature as curv
from repro_torch.core.batch_scaler import BatchScaler, measured_peak_bytes
from repro_torch.core.controller import init_control, with_curvature
from repro_torch.core.precision import TriAccelConfig
from repro_torch.kernels.layout import slab_view
from repro_torch.optim.optimizers import adamw, sgdm
from repro_torch.train.schedules import warmup_cosine
from repro_torch.train.train_step import (TrainState, init_compute,
                                          make_train_step, pack_state,
                                          resolve_fused)


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
    ckpt_dir: Optional[str] = None    # checkpointing: not ported yet
    log_every: int = 10
    b_curv: int = 4
    elastic_true_batch: bool = True   # paper mode: rung changes global B
    fused_update: Optional[bool] = None
    #: re-runs of the same batch at smaller rungs before an OOM re-raises
    max_oom_retries: int = 3


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
                 device="cuda", fault_plan=None):
        self.device = resolve_device(device)
        if task.device != self.device:
            raise ValueError(f"task lives on {task.device}, trainer asked "
                             f"for {self.device}")
        if tcfg.ckpt_dir is not None or fault_plan is not None:
            raise NotImplementedError(
                "checkpointing and fault plans are not ported yet "
                "(ROADMAP A7, A11)")
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
            resident_params=self._params_like if self.resident else None)
        control = init_control(self.grouping.num_layers, tac, self.device)
        if self.resident:
            compute = init_compute(task, params, self.grouping, control, tac)
            state = TrainState(params, aux_state, opt.init(params), control,
                               compute)
            self.state = pack_state(self.view, state, task.compute_dtype)
        else:
            self.state = TrainState(params, aux_state, opt.init(params),
                                    control, ())

        mm = task.memory_model(params, opt_slots=opt.slots)
        self.scaler = BatchScaler(tcfg.rungs,
                                  task.tokens_per_sample(tcfg.seq_len), mm,
                                  tac, start_rung=tcfg.start_rung)
        self.stream = task.data_stream(self.scaler.microbatch,
                                       seed=tcfg.seed, seq_len=tcfg.seq_len)
        #: rung -> peak bytes measured around the rung's first step (cuda)
        self.measured_bytes: Dict[int, float] = {}
        self.metrics_log: List[Dict[str, Any]] = []
        self.oom_events: list = []       # (step, rung) per caught OOM

    # ------------------------------------------------------------- utils --
    def params_tree(self):
        """f32 master params in TREE form (on the resident path, views of
        the master slab) — the eval/export boundary."""
        if not self.resident:
            return self.state.params
        return self.view.unpack(self.state.params, like=self._params_like)

    def _batch_for_rung(self, rung: int, step: int):
        stream = dataclasses.replace(self.stream, global_batch=rung) \
            if self.tcfg.elastic_true_batch else self.stream
        return stream.batch(step)

    # -------------------------------------------------------------- run ---
    def run(self, steps: Optional[int] = None):
        steps = steps if steps is not None else self.tcfg.total_steps
        start = int(self.state.control.step)
        t0 = time.time()
        for step in range(start, start + steps):
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
            if step % self.tcfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, rung=rung,
                         mem_gb=self.scaler._mem(self.scaler.idx) / 1e9,
                         wall_s=round(time.time() - t0, 4))
                self.metrics_log.append(m)
        return self.metrics_log

    def _dispatch(self, step: int):
        """One train step with OOM step-down: an out-of-memory error
        poisons the rung and re-runs the SAME batch one rung lower, at most
        ``max_oom_retries`` times; an OOM on the smallest rung re-raises."""
        err: Optional[BaseException] = None
        for _ in range(self.tcfg.max_oom_retries + 1):
            rung = self.scaler.microbatch
            batch = self._batch_for_rung(rung, step)
            try:
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
            except torch.cuda.OutOfMemoryError as e:
                err = e
                self.oom_events.append((step, rung))
                if self.scaler.mark_oom(rung) == rung:
                    break                   # smallest rung OOM'd: escalate
        raise err

    def _curvature(self, step: int):
        mb = self.stream.batch(step)
        small = {k: v[:self.tcfg.b_curv] for k, v in mb.items()}
        leaves, treedef = tu.flatten(self.params_tree())
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        params = tu.unflatten(treedef, leaves)
        if self.tac.curvature_method != "fisher":
            raise NotImplementedError(
                f"curvature_method={self.tac.curvature_method!r}: only the "
                "fisher proxy is ported (hutchinson/power need jvp-of-grad)")
        loss = self.task.curvature_loss(params, self.state.aux_state, small)
        grads = torch.autograd.grad(loss, leaves)
        return curv.fisher_layer(tu.unflatten(treedef, list(grads)),
                                 self.grouping.mean)
