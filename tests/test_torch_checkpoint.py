"""Port parity for checkpointing: ``repro_torch.checkpoint`` against
``repro.checkpoint``, the ``Trainer``'s checkpoint boundary against the
reference ``Trainer``'s, resume and SIGTERM preemption, on the CPU.

Models: smollm-135m's reduced widths at 2 layers on the naive attention
path (``reduced_config``'s: d 64, 4 heads, kv 2, head_dim 16, d_ff 128,
vocab 512), S 64, B 2, built in both packages; ResNet-18 at full width,
batch 4, for its BatchNorm state and ``run_method``.

What must hold:
  * the port's ``save_checkpoint`` writes the reference's files byte for
    byte (bf16, fp8, int32 and 0-d leaves included) and the same
    manifest, and each package restores the other's files bitwise;
  * a checkpoint written by either package's ``Trainer`` restores into the
    other's with masters, moments, control and aux state bitwise equal:
    the slab-resident fused path, the tree-form reference path, and the
    4-field state of a reference-path run restored by a fused trainer
    (both packages then re-seed the same compute copy, bitwise);
  * two further steps from the restored state, the same batches on both
    sides, within the step-parity tolerances of
    ``tests/test_torch_lm_train.py`` and ``tests/test_torch_reference_step
    .py`` for this LM, applied to each step: loss within rtol 1e-4;
    step, codes and loss scale equal; the momentum leaf by leaf within
    5e-2 of the leaf's largest magnitude (on the reference path, which
    rounds the gradient through the bf16 tier in the loss, plus one bf16
    step, 2^-7, of each element); each side's master step p1 - p0 =
    -lr m1 up to one f32 rounding on each side, 2^-21 (|p0| + |q0| + |p1|
    + |q1|) for the two sides' p and q; var_ema within rtol 1e-2;
  * a resumed CPU run is bitwise the uninterrupted one;
  * the storage faults (``CORRUPTION_KINDS``, dealt by the port's
    ``corrupt_checkpoint`` and once by the reference's) on port-written
    generations fall back a generation with a warning, and an explicit
    step raises;
  * the ``Trainer`` takes a fault plan; ``ServeSession`` still refuses
    one by name.

This file holds the format and integrity checks and the helpers; the
trainer-to-trainer restores run in ``test_torch_checkpoint_interop.py``,
resume in ``test_torch_checkpoint_resume.py``, preemption in
``test_torch_checkpoint_preempt.py`` (files of their own, so xdist's
loadfile workers share them).
"""
import dataclasses
import json
import os
import signal
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import checkpoint as jck  # noqa: E402
from repro.configs import smollm_135m as jconf  # noqa: E402
from repro.core.controller import ControlState as JControl  # noqa: E402
from repro.core.precision import TriAccelConfig as JTac  # noqa: E402
from repro.resilience import faults as jfaults  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.train.task import LMTask as JLMTask  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.configs import smollm_135m as conf  # noqa: E402
from repro_torch.core.precision import TriAccelConfig  # noqa: E402
from repro_torch.resilience import (CORRUPTION_KINDS,  # noqa: E402
                                    corrupt_checkpoint)
from repro_torch.train import paper_harness  # noqa: E402
from repro_torch.train.task import LMTask  # noqa: E402
from repro_torch.train.train_step import TrainState  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_dense_archs import _one_intra_op_thread  # noqa: E402, F401

S, B, VOCAB = 64, 2, 512
LM = (2, 64, 4, 2, 16, 128, VOCAB)
TAC = dict(ladder="gpu", t_ctrl=1, t_curv=40, tau_low=3e-9, tau_high=1e-5,
           alpha=0.05, tau_curv=50.0, curvature_method="fisher")
TCFG = dict(total_steps=10, seq_len=S, rungs=(B,), log_every=1)


@pytest.fixture
def signals_kept():
    """Restore the SIGTERM and SIGINT handlers a test replaces: the workers
    that share this process go on to run other files."""
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield
    finally:
        for s, h in prev.items():
            signal.signal(s, h)


@pytest.fixture(scope="module")
def refs():
    """The reference's trainers over the reduced LM, two steps in: the
    slab-resident fused one and the tree-form reference-path one."""
    out = {}
    for kind, fused in (("fused", None), ("tree", False)):
        tr = JTrainer(JLMTask(jconf._make(*LM, impl="naive")), JTac(**TAC),
                      JTrainerConfig(fused_update=fused, **TCFG))
        tr.run(2)
        out[kind] = tr
    assert out["fused"].resident and not out["tree"].fused
    return out


def _port(kind, ckpt_dir=None, **over):
    task = LMTask(conf._make(*LM, impl="naive"), device="cpu")
    tcfg = TrainerConfig(fused_update=False if kind == "tree" else None,
                         ckpt_dir=None if ckpt_dir is None else str(ckpt_dir),
                         **{**TCFG, **over})
    return Trainer(task, TriAccelConfig(**TAC), tcfg, device="cpu")


def _bits(a):
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint8)
    return a


def _ref_host(state):
    """A reference state (any device) -> {keystr: host array, narrow
    floats as their bits}."""
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]
    return {jax.tree_util.keystr(p): _bits(x) for p, x in flat}


def _port_host(state):
    return {k: a for k, (a, _) in ck._host_leaves(state)}


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
            and a.tobytes() == b.tobytes())


def _assert_bitwise(got, want, keys=None):
    keys = sorted(want) if keys is None else keys
    assert keys
    bad = [k for k in keys if not _same(got[k], want[k])]
    assert not bad, bad


def _with_dir(jtr, d):
    jtr.tcfg = dataclasses.replace(jtr.tcfg, ckpt_dir=str(d))
    jtr.ckpt = jck.AsyncCheckpointer(str(d), jtr.tcfg.ckpt_keep)


def _wait_for(flag):
    for _ in range(1000):
        if flag():
            return True
        time.sleep(0.001)
    return False


# ---------------------------------------------------------------- format --
def _narrow_tree():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    return {"bf16": x.astype(ml_dtypes.bfloat16),
            "fp8": (x / 4).astype(ml_dtypes.float8_e4m3fn),
            "f32": x, "i32": np.arange(7, dtype=np.int32),
            "scalar": np.float32(2.0 ** 15), "step": np.int32(12)}


def _resnet_state():
    """A port ResNet-18 trainer's tree-form state after one CPU step (its
    BatchNorm statistics moved), and the same as a reference TrainState of
    numpy leaves."""
    tr = paper_harness.make_trainer("triaccel", "resnet18", steps=2,
                                    batch0=4, device="cpu")[0]
    tr.run(1)
    host = {k: a for k, (a, _) in ck._host_leaves(tr._save_state())}
    st = tr._save_state()

    def np_tree(field, tree):
        keys = [k for k in tu.keystrs(st) if k.startswith(field)]
        return tu.unflatten(tu.flatten(tree)[1], [host[k] for k in keys])
    ref = jts.TrainState(
        np_tree(".params", st.params), np_tree(".aux_state", st.aux_state),
        np_tree(".opt_state", st.opt_state),
        JControl(*[host[f".control.{f}"] for f in JControl._fields]),
        np_tree(".compute", st.compute))
    return tr, st, ref


@pytest.mark.parametrize("which", ["lm", "narrow", "resnet18"])
def test_save_writes_the_reference_bytes(refs, which, tmp_path):
    """The same state saved by each package: the same files, byte for
    byte, and the same manifest; each package restores the other's files
    bitwise, and a port trainer restores the reference's."""
    port_tr = None
    if which == "lm":
        jstate = jax.device_get(refs["fused"]._save_state())
        pstate = TrainState(bridge.tree(jstate.params),
                            bridge.tree(jstate.aux_state),
                            bridge.tree(jstate.opt_state),
                            bridge.control_state(jstate.control._asdict()),
                            bridge.tree(jstate.compute))
        port_tr = _port("fused")
    elif which == "narrow":
        jstate = _narrow_tree()
        pstate = bridge.tree(jstate)
    else:
        port_tr, pstate, jstate = _resnet_state()
    jdir, pdir = tmp_path / "ref", tmp_path / "port"
    jck.save_checkpoint(str(jdir), 7, jstate)
    ck.save_checkpoint(str(pdir), 7, pstate)
    a, b = jdir / "step_000000000007", pdir / "step_000000000007"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert len(names) == len(tu.leaves(pstate)) + 1
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    assert jck._read_manifest(str(jdir), 7) == ck._read_manifest(
        str(pdir), 7)
    dtypes = {m["dtype"] for m in ck._read_manifest(str(pdir), 7).values()}
    assert "int32" in dtypes and "float32" in dtypes
    assert "bfloat16" in dtypes or which == "resnet18"
    # each package restores the other's files, bitwise
    want = _ref_host(jstate)
    _assert_bitwise(_port_host(ck.restore_checkpoint(str(jdir), pstate)),
                    want)
    _assert_bitwise(_ref_host(jck.restore_checkpoint(str(pdir), jstate)),
                    want)
    if which == "resnet18":      # the resident template names these keys
        tmpl = port_tr._tree_template()
        assert tu.keystrs(tmpl) == tu.keystrs(pstate)
        assert all(x.device.type == "meta" for x in tu.leaves(tmpl.params))
        assert any(k.startswith(".aux_state['bn_stem']") for k in want)
    if port_tr is not None:          # the port's Trainer, from the reference
        port_tr.tcfg = dataclasses.replace(port_tr.tcfg, ckpt_dir=str(jdir))
        assert port_tr.maybe_restore() == int(want[".control.step"])
        _assert_bitwise(_port_host(port_tr._save_state()), want)


# ------------------------------------------------------------- integrity --
def _two_generations(d):
    """Port-written generations 1 and 2 of a small state -> (state at 1,
    template)."""
    tr = _port("fused")
    tr.run(1)
    first = _port_host(tr._save_state())
    ck.save_checkpoint(str(d), 1, tr._save_state())
    tr.run(1)
    ck.save_checkpoint(str(d), 2, tr._save_state())
    return first, tr._tree_template()


@pytest.mark.parametrize("kind", CORRUPTION_KINDS)
def test_corrupt_generation_falls_back_with_a_warning(kind, tmp_path):
    first, tmpl = _two_generations(tmp_path)
    corrupt_checkpoint(str(tmp_path), kind)
    with pytest.warns(RuntimeWarning, match="failed verification"):
        back = ck.restore_checkpoint(str(tmp_path), tmpl)
    _assert_bitwise(_port_host(back), first)
    with pytest.raises(ck.CheckpointCorruptError):
        ck.restore_checkpoint(str(tmp_path), tmpl, step=2)
    # the reference reads the damaged directory the same way
    assert jck.latest_step(str(tmp_path)) == ck.latest_step(str(tmp_path))


def test_generation_damaged_by_the_reference_falls_back(tmp_path):
    """A torn leaf dealt by the reference's ``corrupt_checkpoint`` on a
    port-written generation: the port falls back as for its own."""
    first, tmpl = _two_generations(tmp_path)
    jfaults.corrupt_checkpoint(str(tmp_path), "truncate_leaf",
                               np.random.default_rng(0))
    with pytest.warns(RuntimeWarning, match="failed verification"):
        back = ck.restore_checkpoint(str(tmp_path), tmpl)
    _assert_bitwise(_port_host(back), first)


def test_lr_demote_fill_and_schema_mismatch(tmp_path):
    """A generation written before ``lr_demote`` existed (its entry and
    file both gone: a consistent older schema) restores with the trainer's
    fill at 1.0; without a fill it is a KeyError, not a fallback."""
    tr = _port("fused", tmp_path)
    tr.run(1)
    d = tmp_path / "step_000000000001"
    man = ck._read_manifest(str(tmp_path), 1)
    key = ".control.lr_demote"
    os.remove(d / man.pop(key)["file"])
    with open(d / "manifest.json", "w") as f:
        json.dump({"step": 1, "leaves": man}, f, indent=1)
    with pytest.raises(KeyError):
        ck.restore_checkpoint(str(tmp_path), tr._tree_template())
    fresh = _port("fused", tmp_path)
    fresh.state = fresh.state._replace(control=fresh.state.control._replace(
        lr_demote=torch.tensor(0.25)))
    assert fresh.maybe_restore() == 1
    assert float(fresh.state.control.lr_demote) == 1.0
    assert fresh.state.control.lr_demote.dtype == torch.float32


def test_keep_n_and_no_temporary_remnants(tmp_path):
    state = bridge.tree(_narrow_tree())
    ckpt = ck.AsyncCheckpointer(str(tmp_path), keep=2)
    for step in (3, 5, 8, 13):
        ckpt.save(step, state)
    ckpt.wait()
    assert ckpt.last_saved == 13
    assert sorted(os.listdir(tmp_path)) == [
        "step_000000000008", "step_000000000008.COMMITTED",
        "step_000000000013", "step_000000000013.COMMITTED"]
    assert ck.latest_step(str(tmp_path)) == 13
    assert ck.manifest_keys(str(tmp_path)) == sorted(tu.keystrs(state))


def test_save_snapshots_before_it_returns(tmp_path):
    """``save`` copies the state to the host before it returns: a tensor
    changed in place right after (as the next step changes the slabs the
    tree-form state views) does not reach the file."""
    x = torch.arange(1 << 16, dtype=torch.float32)
    ckpt = ck.AsyncCheckpointer(str(tmp_path))
    ckpt.save(1, {"x": x})
    x.add_(1.0)
    ckpt.wait()
    back = ck.restore_checkpoint(str(tmp_path), {"x": x})["x"]
    assert torch.equal(back, torch.arange(1 << 16, dtype=torch.float32))


def test_background_write_error_surfaces_at_the_next_call(tmp_path):
    blocker = tmp_path / "not_a_directory"
    blocker.write_text("")
    ckpt = ck.AsyncCheckpointer(str(blocker))
    ckpt.save(1, {"x": torch.zeros(3)})         # returns; the write fails
    with pytest.raises(RuntimeError, match="background checkpoint") as ei:
        ckpt.wait()
    assert isinstance(ei.value.__cause__, OSError)
    ckpt.save(2, {"x": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="background checkpoint"):
        ckpt.save(3, {"x": torch.zeros(3)})
    ckpt.wait()                                  # the error was raised once
