"""Paper-reproduction harness: AMP-static vs Tri-Accel and the Table 2
ablations on the paper's ResNet-18 and EfficientNet-B0 / CIFAR-class
testbeds, through the ported ``Trainer``.

Method wiring (Table 1 + Table 2 ablations):
    fp32          true fp32, no rounding (reference_step)  (paper FP32)
    amp           static codes=1 (uniform bf16)            (paper AMP)
    batch_only    static codes=1 + memory-elastic rungs    (Table 2 row 2)
    prec_only     dynamic per-layer codes, fixed batch     (Table 2 row 3)
    triaccel      dynamic codes + curvature LR + rungs     (full method)
    triaccel_fp8  the full method on the tpu (fp8) ladder
``fp32`` turns dynamic precision off, so its trainer runs
``reference_step`` over tree-form state; the others run the slab-resident
fused step.

Metrics per the paper: top-1 accuracy on a held-out stream, wall-clock
time per epoch on this device, modeled time per epoch (tier speed
integrated over the actual rung/precision trajectory), modeled memory and
the efficiency score Acc / (time * mem%). On the card the result also
carries the measured peak allocator bytes and the per-step log.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch import tree as tu
from repro_torch.core.batch_scaler import MemoryModel
from repro_torch.core.precision import TriAccelConfig
from repro_torch.models.vision import VisionConfig
from repro_torch.train.task import VisionTask
from repro_torch.train.trainer import Trainer, TrainerConfig

PAPER_FP32_GB = {"resnet18": 0.35, "efficientnet_b0": 0.301}
# Per-tier relative matmul throughput per precision LADDER (the modeled-
# time yardstick of the reference harness, kept for comparable outputs)
TIER_SPEED = {"gpu": {0: 4.0, 1: 4.0, 2: 1.0},
              "tpu": {0: 8.0, 1: 4.0, 2: 1.0}}

_PORTED_METHODS = ("fp32", "amp", "batch_only", "prec_only", "triaccel",
                   "triaccel_fp8")


def activation_elems(cfg: VisionConfig) -> float:
    """Stored-activation elements per image (feature-map sums)."""
    S = 32 // cfg.stem_stride
    if cfg.name == "resnet18":
        maps = [(S, 64)] + [(S, 64)] * 4 + [(S // 2, 128)] * 4 + \
            [(S // 4, 256)] * 4 + [(S // 8, 512)] * 4
        return float(sum(h * h * c * 2 for h, c in maps))
    maps = [(S, 32), (S, 16), (S // 2, 24), (S // 4, 40), (S // 8, 80),
            (S // 8, 112), (S // 16, 192), (S // 16, 320), (S // 16, 1280)]
    return float(sum(h * h * c * 6 for h, c in maps))


@dataclasses.dataclass
class MethodResult:
    method: str
    arch: str
    accuracy: float
    wall_time_s: float          # measured on this device, per epoch
    model_time_s: float         # tier-weighted model, per epoch
    model_mem_gb: float         # calibrated byte model
    eff_score: float
    frac_low: float
    frac_fp32: float
    final_batch: int
    batch_history: List[int]
    resumed_from: int = 0
    codes: List[int] = dataclasses.field(default_factory=list)
    #: rung -> peak allocator bytes around its first step (cuda only)
    measured_bytes: Dict[int, float] = dataclasses.field(default_factory=dict)
    #: per-layer curvature of the last §3.2 refresh (zeros before one)
    curvature: List[float] = dataclasses.field(default_factory=list)
    log: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


def _tac_for(method: str, mem_cap_gb: float) -> TriAccelConfig:
    base = dict(ladder="gpu", t_ctrl=10, t_curv=40, b_curv=8,
                tau_low=3e-9, tau_high=1e-5, alpha=0.05, tau_curv=50.0,
                mem_cap_bytes=mem_cap_gb * 1e9, rho_low=0.80, rho_high=0.92,
                curvature_method="fisher")
    if method == "triaccel_fp8":
        return TriAccelConfig(**dict(base, ladder="tpu"))
    if method == "fp32":
        fp32 = dict(base, tau_high=-1.0)
        return TriAccelConfig(**fp32, enable_precision=False,
                              enable_curvature=False, enable_batch=False,
                              dynamic_precision=False)
    if method == "amp":
        return TriAccelConfig(**base, enable_precision=False,
                              enable_curvature=False, enable_batch=False)
    if method == "batch_only":
        return TriAccelConfig(**base, enable_precision=False,
                              enable_curvature=False)
    if method == "prec_only":
        return TriAccelConfig(**base, enable_curvature=False,
                              enable_batch=False)
    return TriAccelConfig(**base)  # full triaccel


def vision_memory_model(cfg: VisionConfig, params) -> MemoryModel:
    n = sum(int(x.numel()) for x in tu.leaves(params))
    mm = MemoryModel(param_count=n, opt_slots=1,
                     act_bytes_per_token_layer=activation_elems(cfg) * 2.0,
                     num_layers=1, fixed_overhead=0.05e9)
    # one-dof calibration on the paper's FP32 point (batch 96, codes=fp32)
    mm.calibrate(PAPER_FP32_GB[cfg.name] * 1e9, 96, codes=[2], ladder="gpu")
    return mm


def _trajectory_time(metrics_log, method: str, steps: int,
                     ladder: str = "gpu") -> float:
    """Modeled time integrated over the actual (rung, codes) trajectory:
    step t costs rung_t / speed_t (layer-weighted mean tier speed)."""
    spd = TIER_SPEED[ladder]
    total = 0.0
    for m in metrics_log:
        if method == "fp32":
            speed = spd[2]
        elif method == "amp":
            speed = spd[1]
        else:
            lo, hi = m["frac_low"], m["frac_fp32"]
            mid = max(0.0, 1.0 - lo - hi)
            speed = lo * spd[0] + mid * spd[1] + hi * spd[2]
        total += m["rung"] / max(speed, 1e-9)
    return total * steps / max(len(metrics_log), 1)


def make_trainer(method: str, arch: str = "resnet18", steps: int = 60,
                 batch0: int = 32, seed: int = 0, num_classes: int = 10,
                 ckpt_dir: Optional[str] = None, device="cuda"):
    """-> (trainer, task, memory model, TriAccelConfig) wired as
    ``run_method`` runs ``method``."""
    if method not in _PORTED_METHODS:
        raise NotImplementedError(f"unknown method {method!r}")
    cfg = VisionConfig(name=arch, num_classes=num_classes)
    task = VisionTask(cfg, device=device)

    # memory cap chosen so the elastic controller has headroom to act, as
    # in the paper's 16GB cards running far below capacity
    pshape, _ = task.init(torch.Generator(), device="meta")
    mm = vision_memory_model(cfg, pshape)
    tac = _tac_for(method, mem_cap_gb=mm.total(batch0 * 2, codes=[1]) / 1e9)
    rungs = tuple(batch0 * i // 2 for i in range(1, 5))

    tcfg = TrainerConfig(
        total_steps=steps, base_lr=0.05, warmup_steps=max(2, steps // 10),
        optimizer="sgdm", momentum=0.9, weight_decay=5e-4, grad_clip=5.0,
        seed=seed, seq_len=1, rungs=rungs, start_rung=batch0,
        ckpt_dir=ckpt_dir, ckpt_every=max(10, steps // 4), log_every=1,
        b_curv=tac.b_curv)
    trainer = Trainer(task, tac, tcfg, device=device)
    if method in ("fp32", "amp", "prec_only"):
        trainer.scaler.idx = rungs.index(batch0)  # fixed-batch baselines
    return trainer, task, mm, tac


def run_method(method: str, arch: str = "resnet18", steps: int = 60,
               batch0: int = 32, seed: int = 0, epoch_steps: int = 20,
               num_classes: int = 10, ckpt_dir: Optional[str] = None,
               device="cuda") -> MethodResult:
    """Train ``method`` for ``steps`` steps and measure it. With
    ``ckpt_dir`` the run checkpoints there and first resumes from it: only
    the remaining steps run (``resumed_from``), and the wall time per
    epoch covers those."""
    trainer, task, mm, tac = make_trainer(method, arch, steps, batch0, seed,
                                          num_classes, ckpt_dir, device)
    resumed = trainer.maybe_restore() if ckpt_dir else 0
    ran = max(steps - resumed, 0)
    log = trainer.run(ran)
    wall = log[-1]["wall_s"] if log else 0.0
    frac_low = log[-1]["frac_low"] if log else 0.0
    frac_fp32 = log[-1]["frac_fp32"] if log else 0.0
    scaler = trainer.scaler

    test = task.eval_stream(256, seed=seed)
    eval_params = trainer.params_tree()
    accs = [float(task.evaluate(eval_params, trainer.state.aux_state,
                                test.batch(i))) for i in range(4)]
    acc = 100.0 * sum(accs) / len(accs)

    codes = [int(c) for c in trainer.state.control.codes.tolist()]
    if method == "fp32":
        codes = [2] * len(codes)
    elif method == "amp":
        codes = [1] * len(codes)
    model_time = _trajectory_time(log, method, steps, tac.ladder) / \
        max(steps, 1)
    mem_gb = mm.total(scaler.microbatch, codes=codes, ladder=tac.ladder) / 1e9
    wall_epoch = wall * epoch_steps / max(ran, 1)
    mem_pct = mem_gb / (tac.mem_cap_bytes / 1e9)
    # a fully resumed run (ran == 0) has no trajectory: model_time is 0,
    # and so is the efficiency
    eff = acc / (model_time * mem_pct) if model_time * mem_pct > 0 else 0.0
    return MethodResult(method, arch, acc, wall_epoch, model_time, mem_gb,
                        eff, frac_low, frac_fp32, scaler.microbatch,
                        [h[1] for h in scaler.history], resumed, codes,
                        dict(trainer.measured_bytes),
                        trainer.state.control.lam.tolist(), log)
