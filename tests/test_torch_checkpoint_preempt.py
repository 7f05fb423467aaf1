"""Port parity for resume and preemption: a resumed CPU run is bitwise the
uninterrupted one (both update paths); the SIGTERM handler chains the
prior one; a SIGTERM checkpoints and exits with 143, and a rerun (of the
``Trainer`` and of the launcher) resumes bitwise; the ``Trainer`` and
``ServeSession`` keep a fault plan. The checks are stated in
``test_torch_checkpoint.py``'s docstring.
"""
import signal

import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.configs import smollm_135m as conf  # noqa: E402
from repro_torch.core.precision import TriAccelConfig  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.resilience import Fault, FaultPlan  # noqa: E402
from repro_torch.serve import ServeConfig, ServeSession  # noqa: E402
from repro_torch.train.task import LMTask  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_checkpoint import (LM, TAC, TCFG,  # noqa: E402
                                   _assert_bitwise, _one_intra_op_thread,
                                   _port, _port_host, _wait_for,
                                   signals_kept)


# ---------------------------------------------------------------- resume --
@pytest.mark.parametrize("kind", ["fused", "tree"])
def test_cpu_resume_is_bitwise_the_uninterrupted_run(kind, tmp_path):
    whole = _port(kind)
    whole.run(4)
    first = _port(kind, tmp_path, ckpt_every=1)
    first.run(2)
    again = _port(kind, tmp_path, ckpt_every=1)
    assert again.maybe_restore() == 2
    log = again.run(2)
    _assert_bitwise(_port_host(again._save_state()),
                    _port_host(whole._save_state()))
    assert [m["loss"] for m in log] == [m["loss"] for m in
                                        whole.metrics_log[2:]]
    # cadence: generations named by the step, holding step + 1, kept 3
    assert sorted(ck._committed_steps(str(tmp_path))) == [2, 3, 4]


# ------------------------------------------------------------ preemption --
def test_preemption_handler_chains_the_prior_sigterm_handler(signals_kept):
    seen = []
    signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    tr = _port("fused")
    tr.install_preemption_handler()
    signal.raise_signal(signal.SIGTERM)
    assert _wait_for(lambda: tr._preempted)
    assert seen == [signal.SIGTERM]              # the prior handler ran
    tr._preempted = False
    signal.raise_signal(signal.SIGINT)           # no KeyboardInterrupt
    assert _wait_for(lambda: tr._preempted)


def test_sigterm_checkpoints_exits_and_a_rerun_resumes(tmp_path,
                                                      signals_kept):
    """SIGTERM during step 1 of 3: a blocking checkpoint at the top of step
    2 and ``SystemExit(143)``; a new trainer resumes at 2 and ends bitwise
    where an uninterrupted run ends."""
    tr = _port("fused", tmp_path)
    tr.install_preemption_handler()
    dispatch = tr._dispatch

    def sigterm_in_step_1(step):
        if step == 1:
            signal.raise_signal(signal.SIGTERM)
        return dispatch(step)
    tr._dispatch = sigterm_in_step_1
    with pytest.raises(SystemExit) as ei:
        tr.run(3)
    assert ei.value.code == 143
    assert ck._committed_steps(str(tmp_path)) == [2]
    again = _port("fused", tmp_path)
    assert again.maybe_restore() == 2
    again.run(1)
    whole = _port("fused")
    whole.run(3)
    _assert_bitwise(_port_host(again._save_state()),
                    _port_host(whole._save_state()))


def test_launcher_resumes_after_sigterm(tmp_path, capsys, monkeypatch,
                                        signals_kept):
    """The launcher with ``--ckpt``: preempted by SIGTERM in step 1, the
    same command again prints ``resumed at step 2`` and ends at the
    uninterrupted run's ``control.step``, bitwise in its state."""
    args = ["--arch", "smollm-135m", "--reduced", "--steps", "3", "--rungs",
            "2", "--seq", "64", "--ladder", "gpu", "--device", "cpu"]
    whole = launch_train.main(args)
    dispatch = Trainer._dispatch

    def sigterm_in_step_1(self, step):
        if step == 1:
            signal.raise_signal(signal.SIGTERM)
        return dispatch(self, step)
    monkeypatch.setattr(Trainer, "_dispatch", sigterm_in_step_1)
    ckpt = ["--ckpt", str(tmp_path)]
    capsys.readouterr()
    with pytest.raises(SystemExit) as ei:
        launch_train.main(args + ckpt)
    assert ei.value.code == 143 and ck.latest_step(str(tmp_path)) == 2
    monkeypatch.setattr(Trainer, "_dispatch", dispatch)
    tr = launch_train.main(args + ckpt)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed at step 2"
    assert int(tr.state.control.step) == int(whole.state.control.step) == 3
    _assert_bitwise(_port_host(tr._save_state()),
                    _port_host(whole._save_state()))
    assert ck.latest_step(str(tmp_path)) == 3


def test_fault_plans_still_raise_by_name():
    """The ``Trainer`` and the ``ServeSession`` take a ``FaultPlan`` and
    keep it (resilience is ported on both sides)."""
    plan = FaultPlan([Fault("train.sigterm", step=5)])
    task = LMTask(conf._make(*LM, impl="naive"), device="cpu")
    tr = Trainer(task, TriAccelConfig(**TAC), TrainerConfig(**TCFG),
                 device="cpu", fault_plan=plan)
    assert tr.fault_plan is plan and tr.rollback_events == []
    sess = ServeSession(task, ServeConfig(prompt_len=8, total_len=16,
                                          rungs=(1,), tiers=(1,)),
                        device="cpu", fault_plan=plan)
    assert sess.fault_plan is plan and sess.oom_events == []
