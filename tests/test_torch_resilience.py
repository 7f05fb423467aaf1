"""Port parity for trainer-side resilience: ``repro_torch.resilience``
against ``repro.resilience``, and the ``Trainer``'s recovery (OOM
step-down, the divergence watchdog's rollback with demotion, the fault
sites) against the reference's, on the CPU.

Model: smollm-135m's reduced widths at 2 layers on the naive attention
path (``tests/test_torch_checkpoint.py``'s LM: d 64, 4 heads, kv 2,
head_dim 16, d_ff 128, vocab 512), S 16.

What must hold:
  * the same faults and seed fire alike in both packages, with the same
    log and the same rng draws after; the same (loss, finite) sequence
    gets the same watchdog decisions; each package damages a copy of one
    port-written generation into the same bytes;
  * the reference's trainer cases (``tests/test_resilience.py``) hold for
    the port; OOM recovery is bitwise the fault-free oracle at the smaller
    rung, also when the OOM strikes after a step computed its outputs
    without writing over its state; the resident step donates its slabs,
    as the reference's, and an OOM after it wrote over them re-raises
    (the reference's ``_state_alive``);
  * a skipped (burst) step keeps the master and momentum slabs and the
    BatchNorm-style aux state bitwise, and the demotion survives a
    checkpoint;
  * one plan (an OOM and a burst with rollback) through the reference
    ``Trainer`` and the port's from the same weights and batches gives the
    same ``oom_events``, ``rollback_events`` and fault log, and masters
    within the LM step's tolerance (``tests/test_torch_lm_train.py``: the
    momentum within 5e-2 of the leaf's largest magnitude, and the master
    step -lr m up to one f32 rounding on each side) carried through the
    run: 5e-2 of the leaf's largest total move plus 2^-21 (|p| + |p_ref|)
    a step.

This file holds the fault plans, the watchdog, the corruption kinds, the
OOM cases and the helpers; the rollback and preemption cases run in
``test_torch_resilience_rollback.py``, the one plan through both trainers
in ``test_torch_resilience_plan.py`` (files of their own, so xdist's
loadfile workers share them).
"""
import dataclasses
import shutil

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import resilience as jres  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import resilience as res  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.configs import smollm_135m as conf  # noqa: E402
from repro_torch.core.precision import TriAccelConfig  # noqa: E402
from repro_torch.resilience import (Fault, FaultPlan,  # noqa: E402
                                    RecoveryConfig)
from repro_torch.train.task import LMTask  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_checkpoint import (LM, _assert_bitwise,  # noqa: E402
                                   _narrow_tree, _port_host)
from test_torch_dense_archs import _one_intra_op_thread  # noqa: E402, F401

S = 16
PKGS = {"port": res, "reference": jres}


# ------------------------------------------------------------- faults -----
def test_public_names_and_config_fields_match():
    assert res.__all__ == jres.__all__
    assert res.FAULT_SITES == jres.FAULT_SITES
    assert res.CORRUPTION_KINDS == jres.CORRUPTION_KINDS
    for a, b in ((res.RecoveryConfig, jres.RecoveryConfig),
                 (res.Fault, jres.Fault)):
        assert [(f.name, f.default) for f in dataclasses.fields(a)] == \
            [(f.name, f.default) for f in dataclasses.fields(b)]
    assert "max_oom_retries" not in {
        f.name for f in dataclasses.fields(TrainerConfig)}
    assert TrainerConfig().recovery == RecoveryConfig()


def _faults(pkg):
    F = pkg.Fault
    return [F("train.step_oom", step=2, rung=4, repeats=2),
            F("train.step_oom", step=5, repeats=None),
            F("train.nonfinite", step=3, repeats=3),
            F("serve.step_oom", step=1, tier=0, repeats=2),
            F("ckpt.corrupt", step=4, kind="drop_manifest", repeats=None),
            F("train.sigterm", step=7)]


def test_fault_plans_fire_alike_in_both_packages():
    """One seeded sequence of queries (site, step, rung, tier) through a
    plan of each package: the same answers, the same log and the same rng
    draws after (``corrupt_checkpoint`` picks its victims from it)."""
    q = np.random.default_rng(11)
    sites = res.FAULT_SITES
    queries = [(sites[int(q.integers(len(sites)))], int(q.integers(10)),
                [None, 2, 4][int(q.integers(3))],
                [None, 0, 1][int(q.integers(3))]) for _ in range(200)]
    out = {}
    for name, pkg in PKGS.items():
        plan = pkg.FaultPlan(_faults(pkg), seed=7)
        answers = []
        for site, step, rung, tier in queries:
            f = plan.fires(site, step, rung=rung, tier=tier)
            answers.append(None if f is None else
                           (f.site, f.step, f.repeats, f.fired, f.kind))
        out[name] = (answers, plan.log, plan.rng.integers(1 << 30, size=8))
    assert out["port"][0] == out["reference"][0]
    assert out["port"][1] == out["reference"][1]
    assert any(a is not None for a in out["port"][0])
    np.testing.assert_array_equal(out["port"][2], out["reference"][2])
    # the reference's own cases: rung-restricted with a budget of two;
    # unlimited repeats
    for pkg in PKGS.values():
        plan = pkg.FaultPlan([pkg.Fault("train.step_oom", step=2, rung=4,
                                        repeats=2)], seed=7)
        assert [(s, r) for s in range(6) for r in (2, 4)
                if plan.fires("train.step_oom", s, rung=r)] == \
            [(2, 4), (3, 4)]
        plan = pkg.FaultPlan([pkg.Fault("serve.step_oom", step=1,
                                        repeats=None)])
        assert [s for s in range(5) if plan.fires("serve.step_oom", s)] \
            == [1, 2, 3, 4]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_invalid_sites_and_kinds_raise(pkg):
    with pytest.raises(ValueError, match="unknown fault site"):
        PKGS[pkg].Fault("train.meteor_strike")
    with pytest.raises(ValueError, match="unknown corruption kind"):
        PKGS[pkg].Fault("ckpt.corrupt", kind="gamma_ray")


def test_simulated_oom_is_the_allocators_exception_type():
    err = res.simulated_oom("train.step_oom", 3, 4)
    assert isinstance(err, torch.OutOfMemoryError)
    assert res.is_oom_error(err) and jres.is_oom_error(err)
    assert res.is_oom_error(torch.OutOfMemoryError("anything"))
    assert res.is_oom_error(RuntimeError("CUDA error: out of memory"))
    assert res.is_oom_error(jres.simulated_oom("train.step_oom", 3))
    assert not res.is_oom_error(ValueError("shape mismatch"))


# ----------------------------------------------------------- watchdog -----
@pytest.mark.parametrize("cfg", [
    dict(max_nonfinite=3),
    dict(max_nonfinite=2, loss_spike_factor=3.0, loss_window=8),
    dict(max_nonfinite=1, loss_spike_factor=1.5, loss_window=4)])
def test_watchdog_decisions_match(cfg):
    """The same seeded (loss, finite) sequence, with NaN, inf, flagged
    steps and spikes, and a reset after each trigger: the same decisions
    and health in both packages."""
    q = np.random.default_rng(3)
    seq = []
    for _ in range(300):
        r = q.random()
        loss = (float("nan") if r < 0.05 else float("inf") if r < 0.08
                else float(q.uniform(8.0, 40.0)) if r < 0.15
                else float(q.uniform(0.9, 1.1)))
        seq.append((loss, bool(q.random() > 0.35)))
    out = {}
    for name, pkg in PKGS.items():
        wd = pkg.DivergenceWatchdog(pkg.RecoveryConfig(watchdog=True, **cfg))
        trail = []
        for loss, finite in seq:
            hit = wd.observe(loss, finite)
            trail.append((hit, wd.healthy))
            if hit:
                wd.reset()
        out[name] = trail
    assert out["port"] == out["reference"]
    assert any(hit for hit, _ in out["port"])
    # the reference's cases on the port's watchdog
    wd = res.DivergenceWatchdog(RecoveryConfig(watchdog=True,
                                               max_nonfinite=3))
    assert not wd.observe(1.0, True) and wd.healthy
    assert not wd.observe(float("nan"), False) and not wd.healthy
    assert not wd.observe(1.0, False)
    assert not wd.observe(0.9, True) and wd.healthy
    assert [wd.observe(1.0, False) for _ in range(3)] == [False, False, True]
    wd = res.DivergenceWatchdog(RecoveryConfig(
        watchdog=True, loss_spike_factor=3.0, loss_window=8))
    assert not any(wd.observe(1.0, True) for _ in range(4))
    assert wd.observe(10.0, True) and not wd.observe(1.1, True)


# ------------------------------------------------------------ corrupt -----
def _tree_bytes(d):
    """{path under ``d``: the file's bytes}."""
    return {str(f.relative_to(d)): f.read_bytes()
            for f in d.rglob("*") if f.is_file()}


@pytest.mark.parametrize("kind", res.CORRUPTION_KINDS)
def test_corrupt_checkpoint_damages_alike(kind, tmp_path):
    """Two copies of one port-written generation, each damaged by one
    package from the same seeded rng: byte-identical directories and the
    same description."""
    src = tmp_path / "src"
    state = bridge.tree(_narrow_tree())
    ck.save_checkpoint(str(src), 4, state)
    ck.save_checkpoint(str(src), 9, state)
    desc = {}
    for name, pkg in PKGS.items():
        shutil.copytree(src, tmp_path / name)
        desc[name] = pkg.corrupt_checkpoint(str(tmp_path / name), kind,
                                            np.random.default_rng(5))
    assert desc["port"] == desc["reference"]
    port, ref = _tree_bytes(tmp_path / "port"), _tree_bytes(
        tmp_path / "reference")
    assert port == ref and port != _tree_bytes(src)
    with pytest.raises(FileNotFoundError):
        res.corrupt_checkpoint(str(tmp_path / "empty"), kind)


# ------------------------------------------------------------ trainer -----
def _task():
    return LMTask(conf._make(*LM, impl="naive"), device="cpu")


def _trainer(tmp_path=None, rungs=(4,), total=6, plan=None, recovery=None,
             ladder="tpu", **kw):
    tac = TriAccelConfig(ladder=ladder, t_ctrl=4, enable_curvature=False,
                         mem_cap_bytes=64e9)
    kw.setdefault("ckpt_every", 100)
    tcfg = TrainerConfig(total_steps=total, seq_len=S, rungs=rungs,
                         ckpt_dir=str(tmp_path) if tmp_path else None,
                         log_every=1000, base_lr=1e-2,
                         recovery=recovery or RecoveryConfig(), **kw)
    return Trainer(_task(), tac, tcfg, device="cpu", fault_plan=plan)


def _host(tr):
    return _port_host(tr._save_state())


def _snap(tree):
    """{keystr: a host copy} of a tree of tensors."""
    return {k: np.array(a) for k, (a, _) in ck._host_leaves(tree)}


def test_oom_recovery_matches_fault_free_oracle():
    """A persistent OOM on the big rung: the recovered run (step down,
    the SAME batch again) is bitwise the oracle trained fault-free on the
    surviving rung."""
    plan = FaultPlan([Fault("train.step_oom", step=0, rung=4, repeats=None)])
    faulted = _trainer(rungs=(2, 4), start_rung=4, plan=plan)
    oracle = _trainer(rungs=(2,))
    faulted.run()
    oracle.run()
    assert faulted.oom_events == [(0, 4)]
    assert faulted.scaler.microbatch == 2
    model = faulted.scaler.model
    assert model.measured_key(4) in model.poisoned
    _assert_bitwise(_host(faulted), _host(oracle))
    assert int(faulted.state.control.step) == int(oracle.state.control.step)


def test_oom_after_the_step_computed_leaves_the_state_intact(tmp_path):
    """An OOM raised after a step computed its outputs. Where the step did
    not write over the state it was given (here: the step run on a copy),
    the retry finds the trainer's state bitwise what the failed attempt
    was given, and ends bitwise where the fault-free oracle ends. The
    resident trainer's own step donates its slabs (as the reference jits
    its step with the state donated): an OOM after its fused apply wrote
    over them re-raises at once, recorded, with no retry and no rescue
    checkpoint (the state is gone), as the reference's ``_state_alive``
    check does."""
    faulted = _trainer(rungs=(2, 4), start_rung=4, total=3)
    oracle = _trainer(rungs=(2,), total=3)
    step_fn, seen = faulted._step_fn, {}

    def late_oom(state, batch):
        if int(batch["tokens"].shape[0]) == 4:
            seen["given"] = _snap(state)
            step_fn(tu.tree_map(torch.clone, state), batch)
            raise torch.OutOfMemoryError("CUDA out of memory (late)")
        if "given" in seen and "retry" not in seen:
            seen["retry"] = _snap(state)
        return step_fn(state, batch)
    faulted._step_fn = late_oom
    faulted.run()
    oracle.run()
    assert faulted.oom_events == [(0, 4)]
    _assert_bitwise(seen["retry"], seen["given"])
    _assert_bitwise(_host(faulted), _host(oracle))

    donated = _trainer(tmp_path, rungs=(2, 4), start_rung=4, total=3)
    assert donated.resident
    step_d = donated._step_fn

    def consumed(state, batch):
        step_d(state, batch)            # writes over the given slabs
        raise torch.OutOfMemoryError("CUDA out of memory (late)")
    donated._step_fn = consumed
    with pytest.raises(torch.OutOfMemoryError):
        donated.run()
    assert donated.oom_events == [(0, 4)]
    assert donated.scaler.microbatch == 4          # no step-down, no retry
    assert ck.latest_step(str(tmp_path)) is None    # no rescue checkpoint


def test_oom_on_smallest_rung_escalates(tmp_path):
    """An OOM that survives every rung checkpoints and re-raises; any
    other error propagates at once."""
    plan = FaultPlan([Fault("train.step_oom", step=0, repeats=None)])
    tr = _trainer(tmp_path, rungs=(2, 4), start_rung=4, plan=plan,
                  recovery=RecoveryConfig(max_oom_retries=3))
    with pytest.raises(torch.OutOfMemoryError) as ei:
        tr.run()
    assert res.is_oom_error(ei.value)
    assert tr.oom_events == [(0, 4), (0, 2)]
    assert ck.latest_step(str(tmp_path)) == 0     # the rescue checkpoint
    other = _trainer()

    def broken(state, batch):
        raise ValueError("not an OOM")
    other._step_fn = broken
    with pytest.raises(ValueError, match="not an OOM"):
        other.run(1)
    assert other.oom_events == []
