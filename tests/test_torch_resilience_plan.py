"""Port parity for one fault plan (an OOM and a burst with rollback)
through the reference ``Trainer`` and the port's from the same weights and
batches: the same event trails, fault log and control, and masters within
the tolerance stated in ``test_torch_resilience.py``'s docstring.
"""
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import checkpoint as jck  # noqa: E402
from repro.configs import smollm_135m as jconf  # noqa: E402
from repro.core.precision import TriAccelConfig as JTac  # noqa: E402
from repro import resilience as jres  # noqa: E402
from repro.train.task import LMTask as JLMTask  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa
from repro_torch import bridge  # noqa: E402
from repro_torch import resilience as res  # noqa: E402
from repro_torch.core.precision import TriAccelConfig  # noqa: E402
from repro_torch.resilience import RecoveryConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_checkpoint import LM, _ref_host  # noqa: E402
from test_torch_resilience import (S, _host,  # noqa: E402
                                   _one_intra_op_thread, _task)


# ------------------------------------------------------- cross-package -----
def _cross_plan(pkg):
    F = pkg.Fault
    return pkg.FaultPlan([F("train.step_oom", step=0, rung=4, repeats=None),
                          F("train.nonfinite", step=2, repeats=3)], seed=3)


def test_one_plan_through_both_trainers(tmp_path):
    """OOM at step 0 on rung 4, a burst at steps 2-4 rolled back to
    generation 2: the reference's ``Trainer`` and the port's, from the
    same weights (the reference's, through a checkpoint) and the same
    batches, give the same event trails and fault log, the same control,
    and masters within the stated tolerance."""
    tac = dict(ladder="gpu", t_ctrl=4, enable_curvature=False,
               mem_cap_bytes=64e9)
    common = dict(total_steps=6, seq_len=S, rungs=(2, 4), start_rung=4,
                  ckpt_every=2, log_every=1, base_lr=1e-2)
    rec = dict(watchdog=True, max_nonfinite=3, max_rollbacks=2)
    jplan, plan = _cross_plan(jres), _cross_plan(res)
    jdir, pdir = tmp_path / "ref", tmp_path / "port"
    jtr = JTrainer(JLMTask(jconf._make(*LM, impl="naive")), JTac(**tac),
                   JTrainerConfig(ckpt_dir=str(jdir),
                                  recovery=jres.RecoveryConfig(**rec),
                                  **common), fault_plan=jplan)
    jck.save_checkpoint(str(jdir), 0, jtr._save_state())
    shutil.copytree(jdir, pdir)
    ptr = Trainer(_task(), TriAccelConfig(**tac),
                  TrainerConfig(ckpt_dir=str(pdir),
                                recovery=RecoveryConfig(**rec), **common),
                  device="cpu", fault_plan=plan)
    assert ptr.maybe_restore() == 0
    p0 = _host(ptr)

    def bridged(rung, step):
        return {k: bridge.tensor(v) for k, v in
                jax.device_get(jtr._batch_for_rung(rung, step)).items()}
    ptr._batch_for_rung = bridged
    jtr.run()
    ptr.run()
    assert ptr.oom_events == jtr.oom_events == [(0, 4)]
    assert ptr.rollback_events == jtr.rollback_events == [(4, 3)]
    assert plan.log == jplan.log and len(plan.log) == 4
    got = _host(ptr)
    want = _ref_host(jtr._save_state())
    for f in ("step", "loss_scale", "lr_demote"):
        assert got[f".control.{f}"].tobytes() == \
            want[f".control.{f}"].tobytes(), f
    assert float(got[".control.lr_demote"]) == 0.5
    applied = 4                                  # steps 0, 1, 3 and 4
    for key in (k for k in want if k.startswith(".params")):
        p, q, start = got[key], want[key], p0[key]
        lim = 5e-2 * np.abs(q - start).max() + 2.0 ** -21 * applied * (
            np.abs(p) + np.abs(q))
        assert np.all(np.abs(p - q) <= lim), key
