"""Port parity for §3.2's Hessian-vector curvature (``core.curvature``:
``hvp``, ``power_iteration_layer``, ``hutchinson_layer_traces``;
``core.grouping.layer_select_fns``) and the trainer's refresh with the
``hutchinson`` and ``power`` methods.

The port takes the HVP by double backward, the reference by
``jax.jvp(jax.grad)``: H is symmetric, so both give H v, rounded in
another order. Tolerances:
  * the quadratics, as the reference's own tests: the top eigenvalue 9.0
    and the per-layer eigenvalues 9.0 and 25.0 within rtol 1e-4, the
    Hutchinson trace 5.0 within rtol 0.05 at 64 probes;
  * the narrow vision model (stem, two MBConv blocks, a basic block, the
    classifier; f32, BatchNorm in train mode): the HVP leaf by leaf within
    1e-4 of the leaf's largest magnitude of the reference's (measured
    below 5e-6; each side is within 5e-6 of the port's f64 HVP), and the
    per-layer Hutchinson traces on the reference's probes within rtol 1e-4
    (measured below 2e-5);
  * the 2-layer smollm-shaped LM (bf16 compute, the chunked attention that
    ``curvature_loss`` pins): the HVP leaf by leaf within 5e-2 of the
    leaf's largest magnitude (measured below 2e-2): bf16 roundings taken
    after sums in another order move entries by about one bf16 ulp of
    their operands, as the LM gradient's parity test states.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smollm_135m as jconf  # noqa: E402
from repro.core import curvature as jcurv  # noqa: E402
from repro.core.grouping import flat_grouping as jflat_grouping  # noqa
from repro.data.synthetic import LMTaskStream as JStream  # noqa: E402
from repro.models import vision as jv  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.train.task import LMTask as JLMTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import smollm_135m as conf  # noqa: E402
from repro_torch.core import curvature as curv  # noqa: E402
from repro_torch.core.grouping import flat_grouping, layer_select_fns  # noqa
from repro_torch.core.precision import TriAccelConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402
from repro_torch.models.vision import VisionConfig  # noqa: E402
from repro_torch.train.task import LMTask, VisionTask  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


@pytest.fixture(autouse=True)
def _process_state():
    """Leave the fallback warnings and launch counts as they were for the
    files that share this worker; no test may leave ``flash_fallback``
    on."""
    warned, launches = set(ops.WARNED_FALLBACKS), dict(ops.LAUNCHES)
    yield
    ops.WARNED_FALLBACKS.clear()
    ops.WARNED_FALLBACKS.update(warned)
    ops.LAUNCHES.update(launches)
    assert not ops.fallback_forced()


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """EfficientNet-B0 on the CPU is thousands of small operations, each a
    parallel region of torch's intra-op pool: with several test workers on
    one machine, the pool's threads wait at barriers for each other most
    of the time. One thread here, the setting restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ the quadratics ---
def test_power_iteration_exact_on_quadratic():
    d = torch.tensor([1.0, 4.0, 9.0])
    params = {"a": torch.ones(3)}
    loss = lambda p: 0.5 * (d * p["a"] ** 2).sum()  # noqa: E731
    lam = curv.power_iteration_layer(loss, params, lambda path: True,
                                     torch.Generator().manual_seed(0), 30)
    np.testing.assert_allclose(float(lam), 9.0, rtol=1e-4)


def test_hutchinson_matches_trace_on_quadratic():
    d = torch.tensor([2.0, 4.0, 6.0, 8.0])
    params = {"w": torch.ones(4)}
    loss = lambda p: 0.5 * (d * p["w"] ** 2).sum()  # noqa: E731
    tr = curv.hutchinson_layer_traces(loss, params,
                                      flat_grouping(params).mean,
                                      torch.Generator().manual_seed(0), 64)
    np.testing.assert_allclose(float(tr[0]), 5.0, rtol=0.05)


def test_curvature_probes_distinct_across_same_shape_layers():
    params = {k: torch.ones((64,)) for k in "abc"}
    v = curv._rademacher_tree(params, torch.Generator().manual_seed(0))
    for x, y in [("a", "b"), ("a", "c"), ("b", "c")]:
        assert not torch.equal(v[x], v[y]), (x, y)
    assert all(set(t.tolist()) == {-1.0, 1.0} for t in v.values())


def test_power_iteration_per_layer_blocks_same_shape():
    """Each per-layer power iteration recovers its own block's top
    eigenvalue, with the predicates ``layer_select_fns`` gives."""
    da, db = torch.tensor([1.0, 4.0, 9.0]), torch.tensor([25.0, 2.0, 3.0])
    params = {"a": torch.ones(3), "b": torch.ones(3)}
    loss = lambda p: 0.5 * ((da * p["a"] ** 2).sum()  # noqa: E731
                            + (db * p["b"] ** 2).sum())
    sel = layer_select_fns(["a", "b"], params)
    assert sorted(sel) == ["a", "b"]
    assert sel["a"](("a",)) and not sel["a"](("b",)) and not sel["a"](())
    lam = {k: curv.power_iteration_layer(
        loss, params, sel[k], torch.Generator().manual_seed(0), 30)
        for k in "ab"}
    np.testing.assert_allclose(float(lam["a"]), 9.0, rtol=1e-4)
    np.testing.assert_allclose(float(lam["b"]), 25.0, rtol=1e-4)


# --------------------------------------------- a narrow vision model ---
def _narrow_vision(rng):
    """Params, BN state and a batch of a narrow EfficientNet/ResNet mix:
    stem 3->8, MBConv (expand 6, k 5, stride 2) 8->16, MBConv (expand 6,
    k 3, stride 1, residual) 16->16, a basic block 16->16, classifier."""
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc  # noqa: E731
                            ).astype(np.float32)

    def bn(c):
        return ({"scale": r(c, sc=0.1) + 1.0, "bias": r(c, sc=0.1)},
                {"mean": np.zeros(c, np.float32),
                 "var": np.ones(c, np.float32)})

    def mb(cin, cout, expand, k):
        mid, se = cin * expand, max(1, cin // 4)
        p, s = {}, {}
        if expand != 1:
            p["expand"] = {"kernel": r(1, 1, cin, mid, sc=0.4)}
            p["bn0"], s["bn0"] = bn(mid)
        p["dw"] = {"kernel": r(k, k, 1, mid, sc=0.3)}
        p["bn1"], s["bn1"] = bn(mid)
        p["se_r"] = {"kernel": r(1, 1, mid, se, sc=0.3)}
        p["se_e"] = {"kernel": r(1, 1, se, mid, sc=0.3)}
        p["project"] = {"kernel": r(1, 1, mid, cout, sc=0.3)}
        p["bn2"], s["bn2"] = bn(cout)
        return p, s

    p, s = {"stem": {"kernel": r(3, 3, 3, 8, sc=0.3)}}, {}
    p["bn_stem"], s["bn_stem"] = bn(8)
    p["m0"], s["m0"] = mb(8, 16, 6, 5)
    p["m1"], s["m1"] = mb(16, 16, 6, 3)
    bb = {"conv1": {"kernel": r(3, 3, 16, 16, sc=0.15)},
          "conv2": {"kernel": r(3, 3, 16, 16, sc=0.15)}}
    bbs = {}
    bb["bn1"], bbs["bn1"] = bn(16)
    bb["bn2"], bbs["bn2"] = bn(16)
    p["bb"], s["bb"] = bb, bbs
    p["fc"] = {"kernel": r(16, 10, sc=0.25), "bias": r(10, sc=0.1)}
    batch = {"images": r(4, 8, 8, 3), "labels": rng.integers(0, 10, 4)}
    return p, s, batch


def _narrow_loss(lib, nn, xent):
    """The narrow model's train-mode loss in ``lib`` (the reference's or
    the port's ``models.vision``)."""
    def loss(p, s, images, labels):
        h, _ = lib.bn_apply(p["bn_stem"], s["bn_stem"],
                            lib.conv(p["stem"], images), True, 0.9)
        h = nn.silu(h)
        h, _ = lib._mbconv(p["m0"], s["m0"], h, 2, 6, True, 0.9)
        h, _ = lib._mbconv(p["m1"], s["m1"], h, 1, 6, True, 0.9)
        h, _ = lib._basic_block(p["bb"], s["bb"], h, 1, True, 0.9)
        logits = h.mean(axis=(1, 2)) @ p["fc"]["kernel"] + p["fc"]["bias"]
        return xent(logits, labels)
    return loss


def _jxent(logits, labels):
    return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                         labels[:, None], axis=1))


def _txent(logits, labels):
    return torch.nn.functional.cross_entropy(logits, labels.long())


@pytest.fixture(scope="module")
def narrow():
    p, s, batch = _narrow_vision(np.random.default_rng(11))
    jloss = _narrow_loss(jv, jax.nn, _jxent)
    tloss = _narrow_loss(tv, torch.nn.functional, _txent)
    jargs = (jax.tree.map(jnp.asarray, s), jnp.asarray(batch["images"]),
             jnp.asarray(batch["labels"]))
    targs = (bridge.tree(s), bridge.tensor(batch["images"]),
             bridge.tensor(batch["labels"]))
    return dict(p=p, jloss=jloss, tloss=tloss, jargs=jargs, targs=targs)


def _leafwise(got, want, rel, what):
    for a, b in zip(tu.leaves(got), jax.tree.leaves(want)):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape, what
        assert np.abs(a - b).max() <= rel * np.abs(b).max(), what


def test_hvp_matches_reference_on_a_narrow_vision_model(narrow):
    rng = np.random.default_rng(12)
    tangent = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32),
        narrow["p"])
    want = jax.jit(lambda p, t: jcurv.hvp(narrow["jloss"], p, t,
                                          *narrow["jargs"]))(
        jax.tree.map(jnp.asarray, narrow["p"]),
        jax.tree.map(jnp.asarray, tangent))
    got = curv.hvp(narrow["tloss"], bridge.tree(narrow["p"]),
                   bridge.tree(tangent), *narrow["targs"])
    _leafwise(got, want, 1e-4, "narrow vision HVP")
    # the product is not trivial: every leaf moves
    assert all(float(h.abs().max()) > 0 for h in tu.leaves(got))


def test_hutchinson_traces_match_reference_on_its_probes(narrow,
                                                         monkeypatch):
    """Two probes drawn by the reference (``split(key, 2)``), carried into
    the port in the same order."""
    jp = jax.tree.map(jnp.asarray, narrow["p"])
    key = jax.random.PRNGKey(7)
    jgrp = jflat_grouping(jp)
    want = jax.jit(lambda p, *a: jcurv.hutchinson_layer_traces(
        narrow["jloss"], p, jgrp.mean, key, 2, *a))(jp, *narrow["jargs"])
    probes = [bridge.tree(z) for z in jax.device_get(jax.jit(
        lambda p: [jcurv._rademacher_tree(p, k)
                   for k in jax.random.split(key, 2)])(jp))]
    it = iter(probes)
    monkeypatch.setattr(curv, "_rademacher_tree", lambda tree, gen: next(it))
    params = bridge.tree(narrow["p"])
    got = curv.hutchinson_layer_traces(
        narrow["tloss"], params, flat_grouping(params).mean,
        torch.Generator(), 2, *narrow["targs"])
    assert next(it, None) is None
    assert got.shape == (jgrp.num_layers,) == (6,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-7)


# ------------------------------------------- a 2-layer smollm-shaped LM ---
def test_hvp_matches_reference_on_a_two_layer_lm():
    """``curvature_loss`` of both packages (the chunked attention under
    ``flash_fallback``; the port's train mode checkpoints each layer and
    each loss chunk, and the double backward recomputes through them)."""
    jcfg = jconf._make(2, 64, 4, 2, 16, 128, 512, impl="flash")
    jtask = JLMTask(jcfg)
    wrapped, aux = jtask.init(jax.random.PRNGKey(0))
    jparams = split_params(wrapped)[0]
    batch = JStream(512, 64, 2, seed=5).batch(0)
    rng = np.random.default_rng(13)
    tangent = jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * 0.1).astype(np.float32),
        jax.device_get(jparams))
    loss = lambda p, b: jtask.curvature_loss(p, aux, b)  # noqa: E731
    want = jax.jit(lambda p, t, b: jcurv.hvp(loss, p, t, b))(
        jparams, jax.tree.map(jnp.asarray, tangent), batch)

    task = LMTask(conf.flash_test_config(2), device="cpu")
    params = bridge.lm_params(jax.device_get(jparams))
    tb = {k: bridge.tensor(v) for k, v in jax.device_get(batch).items()}
    got = curv.hvp(lambda p, b: task.curvature_loss(p, {}, b), params,
                   bridge.tree(tangent), tb)
    _leafwise(got, want, 5e-2, "LM HVP")
    assert all(float(h.abs().max()) > 0 for h in tu.leaves(got))


# ---------------------------------------------------- the trainer ----
@pytest.mark.parametrize("method", ["hutchinson", "power"])
def test_trainer_refreshes_curvature_past_its_first_refresh(method):
    """A CPU ``Trainer`` with ``TriAccelConfig()``'s defaults (only the
    refresh period lowered, and the method named): the refresh at step 2
    runs one Hutchinson probe (``power`` goes the same way, as in the
    reference) and sets a finite, non-zero per-layer curvature."""
    tac = TriAccelConfig(curvature_method=method, t_curv=2)
    assert TriAccelConfig().curvature_method == "hutchinson"
    task = LMTask(conf.flash_test_config(2), device="cpu")
    tr = Trainer(task, tac, TrainerConfig(total_steps=4, seq_len=64,
                                          rungs=(2,), b_curv=2,
                                          log_every=1), device="cpu")
    assert float(tr.state.control.lam.abs().sum()) == 0.0
    log = tr.run(4)
    assert len(log) == 4 and all(np.isfinite(m["loss"]) for m in log)
    lam = tr.state.control.lam
    assert lam.shape == (tr.grouping.num_layers,) == (4,)
    assert bool(torch.isfinite(lam).all()) and float(lam.abs().sum()) > 0
    # the probe is seeded with the step: a second trainer that stops after
    # the same refresh (step 3 refreshes nothing) sets the same vector
    again = Trainer(task, tac, TrainerConfig(total_steps=4, seq_len=64,
                                             rungs=(2,), b_curv=2,
                                             log_every=1), device="cpu")
    again.run(3)
    np.testing.assert_array_equal(again.state.control.lam.numpy(),
                                  lam.numpy())


def test_vision_trainer_hutchinson_refresh_on_efficientnet():
    """The refresh through ``VisionTask.curvature_loss``: EfficientNet-B0
    at full width, one probe over b_curv 2 images (double backward through
    the depthwise convs, squeeze-excite and train-mode BatchNorm); the BN
    running statistics stay out of the graph and unchanged by it."""
    task = VisionTask(VisionConfig("efficientnet_b0"), device="cpu")
    tr = Trainer(task, TriAccelConfig(t_curv=1),
                 TrainerConfig(total_steps=2, seq_len=1, rungs=(2,),
                               b_curv=2), device="cpu")
    tr.run(1)
    aux = [t.clone() for t in tu.leaves(tr.state.aux_state)]
    lam = tr._curvature(1)
    assert lam.shape == (21,)
    assert bool(torch.isfinite(lam).all()) and float(lam.abs().sum()) > 0
    assert all(torch.equal(a, b)
               for a, b in zip(aux, tu.leaves(tr.state.aux_state)))
