"""Port parity for the trainer's divergence watchdog (a burst rolls back to
the last committed generation with the loss scale and ``lr_demote``
halved; no checkpoint or no budget left raises) and its preemption
(the handler chains the prior one; the sigterm fault checkpoints, exits
143 and a restart resumes, or falls back past a torn generation), as the
reference's trainer cases. The checks are stated in
``test_torch_resilience.py``'s docstring.
"""
import math
import signal

import pytest

torch = pytest.importorskip("torch")

from repro_torch.resilience import (DivergenceError, Fault,  # noqa: E402
                                    FaultPlan, RecoveryConfig)
from test_torch_checkpoint import (_assert_bitwise, _wait_for,  # noqa: E402
                                   signals_kept)
from test_torch_resilience import (_one_intra_op_thread,  # noqa: E402
                                   _snap, _trainer)


def test_divergence_rollback_restores_and_demotes(tmp_path):
    """A non-finite burst rolls back to the last committed generation with
    the loss scale and ``lr_demote`` halved; each burst step keeps the
    master and momentum slabs and the aux state bitwise; the run still
    ends at its end, and a restart keeps the demotion."""
    plan = FaultPlan([Fault("train.nonfinite", step=5, repeats=3)])
    rec = RecoveryConfig(watchdog=True, max_nonfinite=3, max_rollbacks=2)
    tr = _trainer(tmp_path, total=10, ladder="gpu", plan=plan, recovery=rec,
                  ckpt_every=2)
    dispatch, skipped = tr._dispatch, []

    def watch(step):
        kept = lambda st: (st.params, st.opt_state, st.aux_state)  # noqa
        before = _snap(kept(tr.state))
        state, metrics, rung = dispatch(step)
        if not bool(metrics["grads_finite"]):
            _assert_bitwise(_snap(kept(state)), before)
            skipped.append(step)
        return state, metrics, rung
    tr._dispatch = watch
    tr.run()
    assert skipped == [5, 6, 7]
    assert len(tr.rollback_events) == 1
    diverged, restored = tr.rollback_events[0]
    assert (diverged, restored) == (7, 5)    # generation 4 holds step 5
    assert int(tr.state.control.step) == 10
    assert float(tr.state.control.lr_demote) == 0.5
    assert tr.state.control.lr_demote.dtype == torch.float32
    assert tr.state.control.loss_scale.dtype == torch.float32
    assert math.isfinite(float(tr.state.control.loss_scale))
    again = _trainer(tmp_path, total=10, ladder="gpu")
    assert again.maybe_restore() == 10
    assert float(again.state.control.lr_demote) == 0.5


def test_rollback_without_checkpoint_raises():
    plan = FaultPlan([Fault("train.nonfinite", step=2, repeats=3)])
    rec = RecoveryConfig(watchdog=True, max_nonfinite=3)
    tr = _trainer(None, total=8, ladder="gpu", plan=plan, recovery=rec)
    with pytest.raises(DivergenceError, match="no committed checkpoint"):
        tr.run()


def test_rollback_budget_exhausted_raises(tmp_path):
    plan = FaultPlan([Fault("train.nonfinite", step=3, repeats=None)])
    rec = RecoveryConfig(watchdog=True, max_nonfinite=2, max_rollbacks=1)
    tr = _trainer(tmp_path, total=12, ladder="gpu", plan=plan, recovery=rec,
                  ckpt_every=2)
    with pytest.raises(DivergenceError, match="budget"):
        tr.run()
    assert len(tr.rollback_events) == 1


def test_preemption_handler_chains_prior_and_registers_sigint(tmp_path,
                                                              signals_kept):
    seen = []
    signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    tr = _trainer(tmp_path)
    tr.install_preemption_handler()
    signal.raise_signal(signal.SIGTERM)
    assert _wait_for(lambda: tr._preempted)
    assert seen == [signal.SIGTERM]
    tr._preempted = False
    signal.raise_signal(signal.SIGINT)          # must not KeyboardInterrupt
    assert _wait_for(lambda: tr._preempted)


def test_preemption_checkpoints_and_exits(tmp_path, signals_kept):
    """The sigterm fault drives the real handler path: blocking save, exit
    143, a restart resumes at the preempted step; a ckpt.corrupt fault on
    that save makes the restart fall back a generation."""
    plan = FaultPlan([Fault("train.sigterm", step=3, repeats=1)])
    tr = _trainer(tmp_path, total=6, plan=plan)
    tr.install_preemption_handler()
    with pytest.raises(SystemExit) as ei:
        tr.run()
    assert ei.value.code == 143
    tr2 = _trainer(tmp_path, total=6)
    assert tr2.maybe_restore() == 3
    tr2.ckpt = None
    tr2.run(3)
    assert int(tr2.state.control.step) == 6
    torn = tmp_path / "torn"
    plan = FaultPlan([Fault("train.sigterm", step=4),
                      Fault("ckpt.corrupt", step=4)], seed=1)
    tr = _trainer(torn, total=6, plan=plan, ckpt_every=2)
    tr.install_preemption_handler()
    with pytest.raises(SystemExit):
        tr.run()
    with pytest.warns(RuntimeWarning, match="failed verification"):
        assert _trainer(torn, total=6).maybe_restore() == 3
