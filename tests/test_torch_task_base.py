"""Port parity for the task base and the public names a ported module
lacked, by name against the reference:

  * ``train.task.TrainTask``: the model and data hooks (``init``,
    ``loss``, ``grouping``, ``data_stream``) raise ``NotImplementedError``
    on the base in both packages; the shared ``memory_model`` is the flat
    ``MemoryModel`` over the parameter count with the given optimizer
    slots (every field equal to the reference's on the same shapes);
    ``curvature_loss`` is the base's loss without QDQ and loss scale under
    ``flash_fallback``, and neither ``VisionTask`` nor ``LMTask`` defines
    its own (as in the reference), while each keeps its ``memory_model``
    override;
  * ``serve.ServeSession.sync_measured`` copies the engine's measured
    bytes into the memory model's (rung, tier) overlay (the port measures
    each path as it runs it, so there is nothing to re-harvest first);
  * ``repro_torch.__version__`` is the reference's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core.batch_scaler import MemoryModel as JMemoryModel  # noqa
from repro.serve import ServeSession as JServeSession  # noqa: E402
from repro.train import task as jtask  # noqa: E402
from repro_torch.configs.smollm_135m import flash_test_config  # noqa
from repro_torch.core.batch_scaler import MemoryModel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import ServeConfig, ServeSession  # noqa: E402
from repro_torch.train import task as ttask  # noqa: E402

HOOKS = [("init", (None,)), ("loss", (None, None, None, None, None)),
         ("grouping", (None,)), ("data_stream", (2,))]


@pytest.mark.parametrize("hook,args", HOOKS, ids=[h for h, _ in HOOKS])
def test_base_model_and_data_hooks_raise(hook, args):
    for base in (ttask.TrainTask(), jtask.TrainTask()):
        with pytest.raises(NotImplementedError):
            getattr(base, hook)(*args)


def test_shared_memory_model_matches_reference():
    shapes = {"a": (3, 5), "b": {"c": (7,)}}
    port = {"a": torch.zeros(3, 5), "b": {"c": torch.zeros(7)}}
    ref = jax.tree.map(lambda s: jnp.zeros(s), shapes,
                       is_leaf=lambda s: isinstance(s, tuple))
    for slots in (1, 2):
        got = ttask.TrainTask().memory_model(port, opt_slots=slots,
                                             mesh_size=2)
        want = jtask.TrainTask().memory_model(ref, opt_slots=slots,
                                              mesh_size=2)
        assert isinstance(got, MemoryModel)
        assert isinstance(want, JMemoryModel)
        names = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == names
        for n in names:
            assert getattr(got, n) == getattr(want, n), n
        assert got.param_count == 11.0


class _Probe(ttask.TrainTask):
    """A task whose loss records what it was called with."""

    def __init__(self):
        self.calls = []

    def loss(self, params, aux_state, batch, codes, qdq_fn):
        self.calls.append((codes, qdq_fn, ops.fallback_forced()))
        return params * 2.0, aux_state, {}


def test_shared_curvature_loss_is_the_loss_under_flash_fallback():
    probe = _Probe()
    assert not ops.fallback_forced()
    out = probe.curvature_loss(torch.tensor(3.0), {}, None)
    assert float(out) == 6.0
    assert probe.calls == [(None, None, True)]
    assert not ops.fallback_forced()
    for port, ref in ((ttask.VisionTask, jtask.VisionTask),
                      (ttask.LMTask, jtask.LMTask)):
        assert ("curvature_loss" in vars(port)) == \
            ("curvature_loss" in vars(ref)) is False
        assert ("memory_model" in vars(port)) == \
            ("memory_model" in vars(ref)) is True
    for name in ("init", "loss", "grouping", "data_stream", "memory_model",
                 "curvature_loss", "eval_stream", "tokens_per_sample",
                 "loss_codes", "init_cache", "prefill", "decode", "infer",
                 "serve_input_spec", "serve_memory_model"):
        assert callable(getattr(ttask.TrainTask, name)), name
        assert callable(getattr(jtask.TrainTask, name)), name


def test_sync_measured_copies_the_engine_table_into_the_overlay():
    assert callable(getattr(JServeSession, "sync_measured"))
    sess = ServeSession(ttask.LMTask(flash_test_config(2), device="cpu"),
                        ServeConfig(prompt_len=16, total_len=32,
                                    rungs=(1, 2), tiers=(0, 1)),
                        device="cpu")
    assert sess.warm() > 0
    assert sess.mm.measured == {}            # nothing measured on the CPU
    sess.engine.measured[("decode", 2, 1)] = 1234.0
    sess.engine.measured[("admit", 2, 1)] = 2345.0
    sess.engine.measured[("decode", 1, 0)] = 99.0
    sess.sync_measured()
    assert sess.mm.measured == {(2, 1): 2345.0, (1, 0): 99.0}
    sess.mm.poisoned.add((1, 0))              # a poisoned path stays pinned
    sess.mm.measured[(1, 0)] = np.inf
    sess.engine.measured[("decode", 1, 0)] = 7.0
    sess.sync_measured()
    assert sess.mm.measured[(1, 0)] == np.inf


def test_version_matches_reference():
    assert repro_torch.__version__ == repro.__version__ == "0.1.0"
