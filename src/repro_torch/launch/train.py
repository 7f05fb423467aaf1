"""Training launcher, as ``repro/launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --seq 1024 --rungs 2,4,8 --steps 20 --ladder gpu

Builds ``Trainer(get_task(arch), tac, tcfg)`` with the reference's
Tri-Accel settings (fisher curvature, ``t_ctrl`` 20, ``t_curv`` 100,
``b_curv`` 2) on one device (``--device``, cuda unless told otherwise),
runs ``--steps`` steps and prints the logged metrics as JSON lines.

``--no-triaccel`` turns precision, curvature, batch rungs and dynamic
precision off: the static baseline in the model's compute dtype (bf16 for
the LMs), trained by ``reference_step``.

Not ported yet, and raising ``NotImplementedError``: ``--ckpt``
(checkpointing, ROADMAP A7) and ``--distributed`` (``jax.distributed`` has
no counterpart: the port runs on one device, ROADMAP A12). The
reference's AOT rung warm-up (``warm_rungs``) and its preemption handler
are left out: PyTorch runs eagerly, and preemption needs checkpointing.
"""
from __future__ import annotations

import argparse
import json


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Tri-Accel training launcher")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--rungs", default="4,8,16")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ladder", default="tpu", choices=["tpu", "gpu"])
    ap.add_argument("--optimizer", default="sgdm", choices=["sgdm", "adamw"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--mem-cap-gb", type=float, default=16.0)
    ap.add_argument("--no-triaccel", action="store_true",
                    help="static bf16 baseline (AMP) instead of Tri-Accel")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host initialisation (not ported)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda unless told otherwise")
    return ap


def main(argv=None, **tac_overrides):
    """Parse ``argv`` (``sys.argv`` when None), train, print the logged
    metrics as JSON lines and return the ``Trainer``. ``tac_overrides``
    replace fields of the launcher's ``TriAccelConfig`` (a caller that
    wants the controls to fire within a short run lowers ``t_ctrl`` and
    ``t_curv``)."""
    args = _parser().parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            "--distributed: jax.distributed has no counterpart in the port, "
            "which runs on one device (ROADMAP A12)")
    if args.ckpt is not None:
        raise NotImplementedError(
            "--ckpt: checkpointing is not ported yet (ROADMAP A7)")
    from repro_torch.core.precision import TriAccelConfig
    from repro_torch.models.registry import get_task
    from repro_torch.train.trainer import Trainer, TrainerConfig

    task = get_task(args.arch, reduced=args.reduced, device=args.device)
    tac = TriAccelConfig(**{
        **dict(ladder=args.ladder, t_ctrl=20, t_curv=100, b_curv=2,
               curvature_method="fisher",
               mem_cap_bytes=args.mem_cap_gb * 1e9,
               enable_precision=not args.no_triaccel,
               enable_curvature=not args.no_triaccel,
               enable_batch=not args.no_triaccel,
               dynamic_precision=not args.no_triaccel),
        **tac_overrides})
    rungs = tuple(int(r) for r in args.rungs.split(","))
    tcfg = TrainerConfig(total_steps=args.steps, base_lr=args.lr,
                         warmup_steps=max(10, args.steps // 20),
                         optimizer=args.optimizer, accum=args.accum,
                         seq_len=args.seq, rungs=rungs, log_every=10)
    tr = Trainer(task, tac, tcfg, device=args.device)
    for m in tr.run(args.steps):
        print(json.dumps({k: (round(v, 5) if isinstance(v, float) else v)
                          for k, v in m.items()}), flush=True)
    return tr


if __name__ == "__main__":
    main()
