"""Port parity for checkpoints across the packages' ``Trainer``s: one
package's trainer writes, the other's restores, bitwise, then two steps on
both sides agree. The checks and tolerances are stated in
``test_torch_checkpoint.py``'s docstring.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.synthetic import LMTaskStream as JStream  # noqa: E402
from repro_torch import bridge  # noqa: E402
from test_torch_checkpoint import (B, S, VOCAB, _assert_bitwise,  # noqa
                                   _one_intra_op_thread, _port,
                                   _port_host, _ref_host, _same, _with_dir,
                                   refs)


# ---------------------------------------------------------------- interop --
def _step_pair(jtr, ptr, k):
    """One step on each side from their states, the reference's batch
    ``k`` on both -> (reference host state, port host state, reference
    metrics, port metrics)."""
    jb = JStream(VOCAB, S, B, seed=5).batch(k)
    pb = {n: bridge.tensor(v) for n, v in jax.device_get(jb).items()}
    jtr.state, jm = jtr._get_step(B)(jtr.state, jb)
    ptr.state, pm = ptr._step_fn(ptr.state, pb)
    return (_ref_host(jtr._save_state()), _port_host(ptr._save_state()),
            jax.device_get(jm), pm)


def _assert_steps_agree(jtr, ptr, qdq: bool):
    j0, p0 = _ref_host(jtr._save_state()), _port_host(ptr._save_state())
    for k in range(2):
        j1, p1, jm, pm = _step_pair(jtr, ptr, k)
        assert bool(pm["grads_finite"]) and bool(jm["grads_finite"])
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        for f in ("step", "codes", "loss_scale"):
            assert _same(p1[f".control.{f}"], j1[f".control.{f}"]), f
        np.testing.assert_allclose(p1[".control.var_ema"],
                                   j1[".control.var_ema"], rtol=1e-2)
        lr = float(jm["lr"])
        assert float(pm["lr"]) == lr
        for key in (k for k in j1 if k.startswith(".params")):
            mk = ".opt_state['mu']" + key[len(".params"):]
            m, n = p1[mk], j1[mk]
            lim = 5e-2 * np.abs(n).max() + (2.0 ** -7 * np.abs(n) if qdq
                                            else 0.0)
            assert np.all(np.abs(m - n) <= lim), mk
            dev = np.abs((p1[key] - j1[key]) - (p0[key] - j0[key])
                         + lr * (m - n))
            assert np.all(dev <= 2.0 ** -21 * (
                np.abs(p0[key]) + np.abs(j0[key]) + np.abs(p1[key])
                + np.abs(j1[key]))), key
        j0, p0 = j1, p1


@pytest.mark.parametrize("path", ["resident", "tree", "four_field"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_trainer_checkpoint_restores_in_the_other_package(refs, path,
                                                          writer, tmp_path):
    """One package's ``Trainer`` writes at the end of its run, the other's
    restores: masters, moments, control and aux bitwise; the 4-field state
    (a reference-path run's) restored by both packages' fused trainers,
    whose re-seeded compute copies are bitwise equal; then two further
    steps on both sides from the same state agree."""
    write_kind = "fused" if path == "resident" else "tree"
    read_kind = "tree" if path == "tree" else "fused"
    jtr = refs[write_kind if writer == "reference" else read_kind]
    try:
        _restore_across(refs, jtr, path, writer, write_kind, read_kind,
                        tmp_path)
    finally:
        for t in refs.values():
            t.tcfg = dataclasses.replace(t.tcfg, ckpt_dir=None)
            t.ckpt = None


def _restore_across(refs, jtr, path, writer, write_kind, read_kind,
                    tmp_path):
    if writer == "reference":
        _with_dir(jtr, tmp_path)
        jtr.ckpt.save(int(jtr.state.control.step), jtr._save_state(),
                      block=True)
        saved = _ref_host(jtr._save_state())
        ptr = _port(read_kind, tmp_path)
        assert ptr.maybe_restore() == int(saved[".control.step"])
        readers = [ptr._save_state()]
        if path == "four_field":         # the reference re-seeds it too
            jtr = refs["fused"]
            _with_dir(jtr, tmp_path)
            assert jtr.maybe_restore() == int(saved[".control.step"])
    else:
        writer_tr = _port(write_kind, tmp_path)
        writer_tr.run(2)
        saved = _port_host(writer_tr._save_state())
        _with_dir(jtr, tmp_path)
        assert jtr.maybe_restore() == int(saved[".control.step"]) == 2
        ptr = writer_tr
        if path == "four_field":          # the port re-seeds it too
            ptr = _port("fused", tmp_path)
            assert ptr.maybe_restore() == 2
    jgot, pgot = _ref_host(jtr._save_state()), _port_host(ptr._save_state())
    keys = [k for k in saved if k.startswith((".params", ".opt_state",
                                              ".control", ".aux_state"))]
    assert any(k.startswith(".control") for k in keys)
    _assert_bitwise(jgot, saved, keys)
    _assert_bitwise(pgot, saved, keys)
    comp = sorted(k for k in jgot if k.startswith(".compute"))
    assert comp == sorted(k for k in pgot if k.startswith(".compute"))
    assert bool(comp) == (read_kind == "fused")
    if comp:
        _assert_bitwise(pgot, jgot, comp)
    _assert_steps_agree(jtr, ptr, qdq=read_kind == "tree")
