"""Port parity for the LM launcher and the ``Trainer`` on the LM: the port's
``launch.train`` on the CPU (Tri-Accel, ``--ckpt`` with resume,
``--no-triaccel``, ``--distributed`` raising) and the main path's code at
the 2-layer flash config (``test_torch_lm_train.py``'s model).
"""
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import smollm_135m as conf  # noqa: E402
from repro_torch.core.precision import TriAccelConfig  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train.task import LMTask  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_lm_train import (S, _one_intra_op_thread,  # noqa: E402
                                 _process_state)


# -------------------------------------------------------------- launcher --
def test_launcher_trains_on_the_cpu(capsys):
    tr = launch_train.main(["--arch", "smollm-135m", "--reduced",
                            "--steps", "3", "--rungs", "2", "--seq", "64",
                            "--ladder", "gpu", "--device", "cpu"],
                           t_ctrl=1, t_curv=2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and '"loss"' in lines[0]      # log_every 10
    assert int(tr.state.control.step) == 3
    assert [r for _, r, _ in tr.scaler.history] == [2, 2]
    assert float(tr.state.control.lam.abs().sum()) > 0   # fisher at step 2


@pytest.mark.parametrize("flag", [["--ckpt"], ["--distributed"],
                                  ["--no-triaccel"]])
def test_launcher_unported_flags_raise(flag, capsys, tmp_path):
    """``--distributed`` is not ported and raises. ``--ckpt`` raised until
    checkpointing was ported: a run with ``--ckpt`` under ``tmp_path``
    trains and checkpoints, and the same command again prints ``resumed at
    step N``, ending at the first run's ``control.step`` with its state.
    ``--no-triaccel`` raised until ``reference_step`` was ported: it now
    trains the static bf16 baseline on the CPU, on the reference path,
    with every control off and the rung fixed."""
    if flag == ["--ckpt"]:
        argv = ["--arch", "smollm-135m", "--reduced", "--seq", "64",
                "--rungs", "2", "--ladder", "gpu", "--device", "cpu",
                "--steps", "2", "--ckpt", str(tmp_path)]
        first = launch_train.main(argv)
        assert capsys.readouterr().out.splitlines()[0].startswith("{")
        assert int(first.state.control.step) == 2
        assert sorted(os.listdir(tmp_path)) == [
            "step_000000000002", "step_000000000002.COMMITTED"]
        again = launch_train.main(argv)
        assert capsys.readouterr().out.splitlines() == ["resumed at step 2"]
        assert int(again.state.control.step) == 2
        assert torch.equal(again.state.params, first.state.params)
        return
    if flag == ["--distributed"]:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            launch_train.main(["--device", "cpu", "--steps", "1"] + flag)
        return
    tr = launch_train.main(["--arch", "smollm-135m", "--reduced", "--seq",
                            "64", "--rungs", "2", "--ladder", "gpu",
                            "--device", "cpu", "--steps", "2"] + flag)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and '"loss"' in lines[0]
    assert not tr.fused and tr.state.compute == ()
    assert not (tr.tac.dynamic_precision or tr.tac.enable_precision
                or tr.tac.enable_curvature or tr.tac.enable_batch)
    assert int(tr.state.control.step) == 2
    assert all(x["grads_finite"] == 1.0 for x in tr.metrics_log)
    assert tr.scaler.microbatch == 2 and tr.scaler.history == []


def test_trainer_runs_the_flash_config_on_the_cpu():
    """The main path's code at the 2-layer flash config: the attention
    goes through the autograd Function (plain versions here) and the
    fisher probe through the chunked path."""
    task = LMTask(conf.flash_test_config(2), device="cpu")
    tac = TriAccelConfig(ladder="gpu", t_ctrl=1, t_curv=2, b_curv=2,
                         curvature_method="fisher")
    tr = Trainer(task, tac, TrainerConfig(total_steps=3, seq_len=S,
                                          rungs=(2,), log_every=1),
                 device="cpu")
    log = tr.run(3)
    assert len(log) == 3
    assert all(np.isfinite(x["loss"]) and x["grads_finite"] == 1.0
               for x in log)
    assert all(x["tokens"] == 2 * S for x in log)
    assert float(tr.state.control.lam.abs().sum()) > 0
