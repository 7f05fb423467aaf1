"""Port parity for the recurrent architectures, mamba2-370m (Mamba-2 SSD)
and recurrentgemma-2b (RG-LRU + local MQA), against the reference package
by name, on the same numpy inputs: weights from the reference's init
(``bridge.lm_params``, which carries ``A_log``, ``D``, ``dt_bias``, the
conv kernels and biases, ``lam`` and the biased ``wa``/``wi`` leaf for
leaf), batches from its ``LMTaskStream``. The shared checks and their
tolerances are ``test_torch_dense_archs.py``'s:

  * the full configs: the ``LMConfig`` and ``StackConfig`` fields and the
    block pattern equal the reference's, with its ``SSMConfig`` /
    ``RGLRUConfig`` / ``AttnConfig``; the parameter tree (``lm_init`` on
    ``meta``) has the reference's paths and shapes (``jax.eval_shape``)
    and its parameter count (368,338,432 / 2,894,574,080);
  * each reduced config in bf16 (mamba2: 3 SSD layers, d 64, state 16,
    head dim 16, chunk 8; recurrentgemma: one (rglru, rglru, local MQA)
    period and a trailing rglru, d 64, window 8): the loss within rtol
    1e-4 and the gradient leaf by leaf within 5e-2 of the leaf's largest
    magnitude (B 2, S 32); one slab-resident fused step carried from the
    reference's state, its momentum leaf by leaf within 5e-2;
    ``registry.get_task(arch, reduced=True, device="cpu")`` trains two
    steps through the ``Trainer``. recurrentgemma's recurrence-gate
    leaves (``wa``, ``lam``) are held to GATE_TOL = 1e-1 of their largest
    magnitude in bf16 instead (gradient and momentum): at init the decay
    a = exp(-8 softplus(lam + 4) r) is ~1e-7, so their gradients are
    ~1e-7, 1e-4 of the block's other leaves, sums over positions of
    products of bf16-rounded factors that partly cancel (measured up to
    7.6e-2). The same model computed in f32 holds every leaf, those
    included, within 2^-16 of its largest magnitude (measured 1.6e-6), so
    the gap is bf16 rounding and not the gate's math;
  * prefill (P 16, a multiple of mamba2's chunk) scattered into decode
    caches of TOTAL 32 slots and 8 teacher-forced decode steps, so
    recurrentgemma's 8-slot ring wraps: prefill and decode logits within
    LOGIT_TOL = 0.02 absolute, every cache leaf (the f32 ``ssm``,
    ``conv`` and ``h`` state rows and the ring's K/V) within CACHE_TOL =
    5e-2 of its largest magnitude, positions equal; the state rows cross
    ``scatter_prefill`` and ``repack_caches`` whole (a per-row shape that
    matches is written directly; a repack's empty row is zeros).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import recurrentgemma_2b as rgemma  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

from test_torch_dense_archs import (  # noqa: E402, F401 (a fixture)
    LOGIT_TOL, _bf16, _caches_close, _leafwise, _np, _one_intra_op_thread,
    _port_batch, _port_params, _slot,
    check_loss_and_grad_match_reference,
    check_registry_task_trains_on_the_cpu,
    check_resident_step_matches_reference, make_ref)

ARCHS = ["mamba2-370m", "recurrentgemma-2b"]
PARAMS = {"mamba2-370m": 368_338_432, "recurrentgemma-2b": 2_894_574_080}
B, P, TOTAL, DECODE = 2, 16, 32, 8
GATE_TOL = 1e-1


def _loose(ref):
    return ({"wa": GATE_TOL, "lam": GATE_TOL}
            if ref["arch"] == "recurrentgemma-2b" else None)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_and_parameter_shapes_match_reference(arch):
    jc, tc = jregistry.get_model_config(arch), registry.get_model_config(arch)
    for f in ("name", "family", "vocab_size", "tie_embeddings",
              "scale_embed", "loss_chunk", "d_model", "num_layers"):
        assert getattr(tc, f) == getattr(jc, f), f
    js, ts = jc.stack, tc.stack
    for f in ("d_model", "d_ff", "act", "gated", "norm_eps", "remat"):
        assert getattr(ts, f) == getattr(js, f), f
    assert [([(b.kind, b.ffn, b.window) for b in defs], n)
            for defs, n in ts.segments] == \
        [([(b.kind, b.ffn, b.window) for b in defs], n)
         for defs, n in js.segments]
    for sub in ("ssm", "rglru", "attn"):
        a, b = getattr(js, sub), getattr(ts, sub)
        assert (a is None) == (b is None), sub
        if a is not None:
            fields = [f for f in vars(a) if f not in ("q_chunk", "k_chunk",
                                                      "mrope_sections")]
            assert {f: getattr(b, f) for f in fields} == \
                {f: getattr(a, f) for f in fields}, sub
    want = jax.eval_shape(lambda: split_params(
        jlm.lm_init(jax.random.PRNGKey(0), jc))[0])
    got = lm.lm_init(None, tc, device="meta")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [tuple(str(getattr(k, "key", k)) for k in path)
            for path, _ in flat] == tu.paths(got)
    assert [tuple(s.shape) for _, s in flat] == \
        [tuple(t.shape) for t in tu.leaves(got)]
    assert sum(t.numel() for t in tu.leaves(got)) == PARAMS[arch]
    if arch == "recurrentgemma-2b":
        assert rgemma.WINDOW == 2048


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return make_ref(request.param)


def test_loss_and_grad_match_reference(ref):
    check_loss_and_grad_match_reference(ref, _loose(ref))


def test_f32_loss_and_grad_match_reference(ref):
    """The reduced model computed in f32 in both packages: every gradient
    leaf within 2^-16 of its largest magnitude, the loss within rtol
    1e-6."""
    cfg_j = dataclasses.replace(ref["cfg"], compute_dtype=jnp.float32)
    cfg_t = dataclasses.replace(ref["cfg_t"], compute_dtype=torch.float32)
    (jtotal, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, cfg_j), has_aux=True))(
        ref["params"], ref["batch"])
    params = tu.tree_map(lambda x: x.requires_grad_(True),
                         _port_params(ref["params"]))
    total, _ = lm.lm_loss(params, _port_batch(ref["batch"]), cfg_t)
    grads = torch.autograd.grad(total, tu.leaves(params))
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-6)
    _leafwise(tu.unflatten(tu.flatten(params)[1], list(grads)), jg,
              2.0 ** -16, "f32 grad")


def test_resident_step_matches_reference(ref):
    check_resident_step_matches_reference(ref, _loose(ref))


def test_registry_task_trains_on_the_cpu(ref):
    check_registry_task_trains_on_the_cpu(ref)


def test_prefill_and_decode_match_reference(ref):
    cfg_j, cfg_t = ref["cfg"], ref["cfg_t"]
    pj = _bf16(jax.device_get(ref["params"]))
    pt = bridge.lm_params(pj)
    names = {p[-1] for p in tu.paths(pt)}
    assert ({"A_log", "D", "dt_bias"} <= names if ref["arch"] ==
            "mamba2-370m" else {"lam", "bias"} <= names)
    V = cfg_j.vocab_size
    rng = np.random.default_rng(1)
    toks = rng.integers(0, V, (B, P)).astype(np.int32)
    lj, prej = jax.jit(lambda p, t: jlm.lm_prefill(p, {"tokens": t},
                                                   cfg_j))(pj, toks)
    lt, pret = lm.lm_prefill(pt, {"tokens": torch.from_numpy(toks)}, cfg_t)
    gap = np.abs(_np(lt) - _np(lj)).max()
    assert gap <= LOGIT_TOL, f"prefill logits differ by {gap}"
    _caches_close(pret, prej, "prefill caches")

    cj = jlm.lm_init_cache(cfg_j, B, TOTAL)
    ct = lm.lm_init_cache(cfg_t, B, TOTAL)
    assert [(tuple(x.shape), str(x.dtype)) for x in tu.leaves(ct)] == \
        [(tuple(x.shape), "torch." + str(x.dtype)) for x in
         jax.tree.leaves(cj)]
    for i in range(B):
        cj = jengine.scatter_prefill(cj, _slot(prej, i), i)
        ct = engine.scatter_prefill(ct, _slot(pret, i), i)
    state = [(n, c) for n, c in engine._named_leaves(ct)
             if n not in engine.SEQUENCE_LEAVES]
    assert {n for n, _ in state} >= {"conv"}
    for (n, c), p in zip(engine._named_leaves(ct),
                         tu.leaves(pret)):           # whole rows, as given
        if n not in engine.SEQUENCE_LEAVES:
            assert torch.equal(c, p.to(c.dtype)), n
    decode_j = jax.jit(lambda p, t, c, i: jlm.lm_decode_step(p, t, c, i,
                                                             cfg_j))
    for step in range(DECODE):                  # teacher-forced decode
        tok = rng.integers(0, V, (B,)).astype(np.int32)
        idx = np.full((B,), P + step, np.int32)
        lj, cj = decode_j(pj, jnp.asarray(tok), cj, jnp.asarray(idx))
        lt, ct = lm.lm_decode_step(pt, torch.from_numpy(tok), ct,
                                   torch.from_numpy(idx), cfg_t)
        gap = np.abs(_np(lt) - _np(lj)).max()
        assert gap <= LOGIT_TOL, f"decode step {step}: logits differ by {gap}"
    _caches_close(ct, cj, "decode caches")
    if ref["arch"] == "recurrentgemma-2b":     # the local ring wrapped
        ring = _np(ct["seg0"]["b2"]["mix"]["pos"])
        assert ring.shape[-1] == 8
        assert sorted(ring[0, 0].tolist()) == list(
            range(P + DECODE - 8, P + DECODE))
    # a repack onto rung 3: rows 1, 0 and an empty row, as the reference's
    src, valid = np.array([1, 0, 0]), np.array([True, True, False])
    rj = jax.device_get(jengine.repack_caches(cj, jnp.asarray(src),
                                              jnp.asarray(valid)))
    rt = engine.repack_caches(ct, torch.from_numpy(src),
                              torch.from_numpy(valid))
    _caches_close(rt, rj, "repacked caches")
    for (n, c), (_, old) in zip(engine._named_leaves(rt),
                                engine._named_leaves(ct)):
        if n not in engine.SEQUENCE_LEAVES:         # whole rows moved
            assert torch.equal(c[:, 0], old[:, 1]) and torch.equal(
                c[:, 1], old[:, 0]) and not c[:, 2].any(), n
