"""Chaos soak, as the reference's ``repro.resilience.soak``: one seeded
``FaultPlan`` driven through a small trainer AND a serve session, end to
end, asserting the recovery contracts:

  * zero process crashes across >= 4 fault classes (step OOM, non-finite
    burst, checkpoint corruption, SIGTERM, serve OOM, latency spike);
  * the serve leg dispatches no path that ``warm()`` did not run (every
    step-down lands on a warmed (rung, tier) path and repack);
  * the restart after SIGTERM restores a VERIFIED generation: the
    corruption fault tears the newest one, so the restore must fall back;
  * divergence rollback resumes from the last committed step with the
    demoted loss scale and LR.

The train leg has no compile count: the reference's ``warm_rungs`` and
``Trainer.compile_count`` count XLA executables, and the port's eager
``Trainer`` has neither, so its report leaves ``compiles_during_run`` out
and its ``ok`` does not test it.

    PYTHONPATH=src python -m repro_torch.resilience.soak --out r.json
    PYTHONPATH=src python -m repro_torch.resilience.soak --device cpu
"""
from __future__ import annotations

import argparse
import json
import shutil
import signal
import sys
import tempfile
import warnings
from typing import Any, Dict

import numpy as np

from repro_torch.resilience.faults import Fault, FaultPlan
from repro_torch.resilience.recovery import RecoveryConfig


def tiny_lm_task(seq_len: int = 16, device="cuda"):
    """A 2-layer d_model=64 LM: big enough to exercise every code path,
    small enough for a quick soak."""
    from repro_torch.models.lm import LMConfig
    from repro_torch.nn.attention import AttnConfig
    from repro_torch.nn.blocks import BlockDef, StackConfig
    from repro_torch.train.task import LMTask
    attn = AttnConfig(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                      impl="naive")
    sc = StackConfig(segments=(((BlockDef("gqa", "dense"),), 2),),
                     d_model=64, d_ff=128, attn=attn, remat=False)
    return LMTask(LMConfig(name="tiny", family="dense", vocab_size=64,
                           stack=sc), device=device)


def train_soak(seed: int = 0, ckpt_dir: str = None,
               device="cuda") -> Dict[str, Any]:
    """Trainer leg: persistent OOM on the big rung at step 3, non-finite
    burst at step 9 (watchdog rollback), SIGTERM at step 21 whose
    preemption checkpoint is immediately torn by the corruption fault;
    the restart must fall back one generation and finish the run. The
    process's SIGTERM and SIGINT handlers are put back at the end."""
    from repro_torch.core.precision import TriAccelConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    own_dir = ckpt_dir is None
    if own_dir:
        ckpt_dir = tempfile.mkdtemp(prefix="soak_ckpt_")
    report: Dict[str, Any] = {"leg": "train", "ok": False}
    handlers = {s: signal.getsignal(s)
                for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        task = tiny_lm_task(device=device)
        tac = TriAccelConfig(ladder="gpu", t_ctrl=2, enable_curvature=False,
                             mem_cap_bytes=64e9)
        tcfg = TrainerConfig(
            total_steps=24, seq_len=16, rungs=(2, 4), start_rung=4,
            ckpt_dir=ckpt_dir, ckpt_every=4, log_every=1,
            recovery=RecoveryConfig(watchdog=True, max_nonfinite=3,
                                    max_rollbacks=2))
        plan = FaultPlan([
            Fault("train.step_oom", step=3, rung=4, repeats=None),
            # burst length = max_nonfinite: the gpu AMP ladder clamps the
            # injected inf back to 2^24 each step, so each burst step must
            # re-fire for the watchdog to see a consecutive run
            Fault("train.nonfinite", step=9, repeats=3),
            Fault("train.sigterm", step=21, repeats=1),
            Fault("ckpt.corrupt", step=21, repeats=1, kind="truncate_leaf"),
        ], seed=seed)
        tr = Trainer(task, tac, tcfg, device=device, fault_plan=plan)
        tr.install_preemption_handler()
        preempted = False
        try:
            tr.run()
        except SystemExit as e:       # the SIGTERM fault's clean exit
            preempted = (e.code == 143)
        report.update(
            preempted=preempted,
            oom_events=list(tr.oom_events),
            rollback_events=list(tr.rollback_events),
            rung_after_oom=tr.scaler.microbatch,
            poisoned=sorted(tr.scaler.model.poisoned),
            fault_log=[(s, st) for s, st, _ in plan.log],
        )

        # --- restart: restore must skip the torn generation -------------
        tr2 = Trainer(task, tac, tcfg, device=device)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            restored = tr2.maybe_restore()
        fell_back = any("failed verification" in str(c.message)
                        for c in caught)
        tr2.run(tcfg.total_steps - restored)
        lr_demote = float(tr2.state.control.lr_demote)
        loss_scale = float(tr2.state.control.loss_scale)
        report.update(
            restored_step=restored, restore_fell_back=fell_back,
            final_step=int(tr2.state.control.step),
            lr_demote=lr_demote, loss_scale=loss_scale)
        report["ok"] = bool(
            preempted
            and tr.oom_events and tr.rollback_events
            and fell_back
            and report["final_step"] == tcfg.total_steps
            and lr_demote < 1.0)
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
        if own_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return report


def serve_plan(seed: int = 0) -> FaultPlan:
    """The serving leg's plan: an unlimited OOM on rung 2 from step 4, one
    on rung 1 at tier 1 from step 10, latency spikes at steps 14 and 15."""
    return FaultPlan([
        Fault("serve.step_oom", step=4, rung=2, repeats=None),
        Fault("serve.step_oom", step=10, rung=1, tier=1, repeats=1),
        Fault("serve.latency", step=14, repeats=2, seconds=0.25),
    ], seed=seed)


def serve_config(**over):
    """The serving leg's ``ServeConfig``; ``over`` replaces fields."""
    from repro_torch.serve.session import ServeConfig
    return ServeConfig(**{**dict(
        prompt_len=4, total_len=12, rungs=(1, 2), tiers=(0, 1),
        max_new_tokens=4, t_ctrl=4, auto_tier=False, max_request_retries=2,
        mem_cap_bytes=64e9), **over})


def serve_soak(seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Serving leg: OOM on the big rung (emergency step-down through the
    repack + (rung, tier) poison), then an OOM at the smallest rung (tier
    demotion), plus a latency spike into the LatencyTable: every request
    must end 'done' or 'failed', never a crashed session."""
    from repro_torch.serve.session import ServeSession

    task = tiny_lm_task(device=device)
    plan = serve_plan(seed)
    sess = ServeSession(task, serve_config(), fault_plan=plan, device=device)
    sess.warm()
    warm_compiles = sess.compile_count
    rng = np.random.default_rng(seed)
    for _ in range(6):
        sess.submit({"tokens": rng.integers(0, 64, size=4).astype(np.int32)})
    out = sess.run(max_steps=400)
    statuses = sorted({r.status for r in sess.results().values()})
    done = sum(r.status == "done" for r in sess.results().values())
    report = {
        "leg": "serve", "steps": out["steps"], "done": done,
        "failed": out["failed"], "statuses": statuses,
        "oom_events": list(sess.oom_events),
        "poisoned": sorted(sess.mm.poisoned),
        "rung_history": out["rung_history"],
        "tier_history": out["tier_history"],
        "compiles_during_run": sess.compile_count - warm_compiles,
        "fault_log": [(s, st) for s, st, _ in plan.log],
    }
    report["ok"] = bool(
        set(statuses) <= {"done", "failed"}
        and done > 0
        and report["compiles_during_run"] == 0
        and sess.oom_events
        and sess.mm.poisoned)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--skip-serve", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    args = ap.parse_args(argv)
    report: Dict[str, Any] = {"seed": args.seed, "legs": []}
    if not args.skip_train:
        report["legs"].append(train_soak(seed=args.seed, device=args.device))
    if not args.skip_serve:
        report["legs"].append(serve_soak(seed=args.seed, device=args.device))
    report["ok"] = bool(report["legs"]) and all(
        leg["ok"] for leg in report["legs"])
    text = json.dumps(report, indent=1, default=str)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
