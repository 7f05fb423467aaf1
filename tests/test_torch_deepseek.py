"""Port parity for the MLA/MoE architectures (deepseek-v2-lite-16b here,
deepseek-v2-236b in ``test_torch_deepseek_236b.py``) against the reference
package, by name, on the same numpy inputs, following
``test_torch_dense_archs.py`` (whose shared checks run here too).

  * The full configs: the ``LMConfig``, ``MLAConfig`` and ``MoEConfig``
    fields equal the reference's, the parameter tree (``lm_init`` on
    ``meta``) has the reference's paths and shapes and parameter count
    (15,706,484,224 / 235,741,434,880), ``SKIP_SHAPES`` and
    ``DRYRUN_ACCUM`` equal. deepseek-v2-lite-16b's full tree groups into
    the reference's per-layer counts and packs into the reference's slab
    rows (the stacked expert leaves (26, 64, 2048, 1408) included), row
    for row.
  * Each reduced config (the reference's ``reduced_config()``: 3 layers,
    layer 0 dense, MLA, 8 experts top-2, capacity 2.0, naive attention):
      - in f32 (``compute_dtype`` float32 on both sides): the loss and
        both aux terms within rtol 1e-5, the gradient leaf by leaf within
        F32_GRAD_TOL = 1e-3 of the leaf's largest magnitude; one
        slab-resident fused step from the reference's state as in
        ``test_torch_dense_archs`` (momentum within 5e-2 of its largest
        magnitude per leaf, masters within 2^-21 of their magnitudes);
      - in bf16 as configured: the router's choices equal the
        reference's except where a token's k-th and (k+1)-th
        probabilities lie within twice the largest gap between the two
        packages' probabilities at that layer (a near-tie that a bf16
        ulp upstream can flip; deepseek-v2-lite's reduced model flips one
        token of 64 at its first MoE layer, with gap 5.5e-4 against a
        largest probability gap of 3.2e-3), and the loss within rtol 1e-3
        (2.3e-4 measured: a flipped token takes other experts' weights);
      - prefill and teacher-forced decode in bf16 (``test_torch_dense_
        archs``' check: logits within 0.02 absolute, caches within 5e-2
        of their largest magnitude, positions equal); decode runs at B 2,
        so C = 1 and the rows compete for expert slots;
      - ``registry.get_task(arch, reduced=True, device="cpu")`` trains
        two steps: finite losses, finite gradients.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_dense_archs as dense  # noqa: E402
from repro.configs import deepseek_v2_236b as jbig  # noqa: E402
from repro.configs import deepseek_v2_lite_16b as jlite  # noqa: E402
from repro.kernels.layout import SlabView as JSlabView  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.train.task import LMTask as JLMTask  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import deepseek_v2_236b as big  # noqa: E402
from repro_torch.configs import deepseek_v2_lite_16b as lite  # noqa: E402
from repro_torch.kernels.layout import SlabView  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.nn import moe  # noqa: E402
from repro_torch.train.task import LMTask  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "deepseek-v2-236b"]
PARAMS = {"deepseek-v2-lite-16b": 15_706_484_224,
          "deepseek-v2-236b": 235_741_434_880}
F32_GRAD_TOL = 1e-3
_one_intra_op_thread = dense._one_intra_op_thread


def make_ref(arch, f32=False):
    """``test_torch_dense_archs.make_ref``; ``f32``: both packages compute
    in float32."""
    ref = dense.make_ref(arch)
    if f32:
        ref["cfg"] = dataclasses.replace(ref["cfg"],
                                         compute_dtype=jnp.float32)
        ref["cfg_t"] = dataclasses.replace(ref["cfg_t"],
                                           compute_dtype=torch.float32)
        ref["task"] = JLMTask(ref["cfg"])
    return ref


# -------------------------------------------------------- full configs ----
@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_and_parameter_shapes_match_reference(arch):
    jc, tc = jregistry.get_model_config(arch), registry.get_model_config(arch)
    for f in ("name", "family", "vocab_size", "tie_embeddings",
              "scale_embed", "loss_chunk", "d_model", "num_layers"):
        assert getattr(tc, f) == getattr(jc, f), f
    js, ts = jc.stack, tc.stack
    for f in ("d_model", "d_ff", "act", "gated", "norm_eps", "remat"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.attn is js.attn is None
    assert dataclasses.asdict(ts.mla) == dataclasses.asdict(js.mla)
    assert dataclasses.asdict(ts.moe) == dataclasses.asdict(js.moe)
    assert [([(b.kind, b.ffn, b.window) for b in defs], n)
            for defs, n in ts.segments] == \
        [([(b.kind, b.ffn, b.window) for b in defs], n)
         for defs, n in js.segments]
    want = jax.eval_shape(lambda: split_params(
        jlm.lm_init(jax.random.PRNGKey(0), jc))[0])
    got = lm.lm_init(None, tc, device="meta")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [tuple(str(getattr(k, "key", k)) for k in path)
            for path, _ in flat] == tu.paths(got)
    assert [tuple(s.shape) for _, s in flat] == \
        [tuple(t.shape) for t in tu.leaves(got)]
    assert sum(t.numel() for t in tu.leaves(got)) == PARAMS[arch]
    mj, mt = (jlite, lite) if arch == "deepseek-v2-lite-16b" else (jbig, big)
    assert mt.SKIP_SHAPES == mj.SKIP_SHAPES
    assert mt.DRYRUN_ACCUM == mj.DRYRUN_ACCUM


def test_full_model_groups_and_packs_as_reference():
    """deepseek-v2-lite-16b at full size, shapes only: the per-layer
    grouping counts and names, and every slot and row of the slab."""
    jc = jregistry.get_model_config("deepseek-v2-lite-16b")
    tc = registry.get_model_config("deepseek-v2-lite-16b")
    want = jax.eval_shape(lambda: split_params(
        jlm.lm_init(jax.random.PRNGKey(0), jc))[0])
    got, _ = LMTask(tc, device="cpu").init(None, device="meta")
    jg, tg = JLMTask(jc).grouping(want), LMTask(tc, "cpu").grouping(got)
    assert tg.num_layers == jg.num_layers == 29
    assert tg.names == list(jg.names)
    np.testing.assert_array_equal(tg.counts.numpy(), np.asarray(jg.counts))
    jv, tv = JSlabView.build(want, jg), SlabView.build(got, tg)
    experts = [s for s in tv.slots if s.shape == (26, 64, 2048, 1408)]
    assert len(experts) == 2           # w_gate and w_up; w_down (26, 64,
    assert tv.rows == jv.rows          # 1408, 2048) beside them
    assert tv.num_layers == jv.num_layers
    assert [dataclasses.astuple(s) for s in tv.slots] == \
        [dataclasses.astuple(s) for s in jv.slots]
    np.testing.assert_array_equal(tv.row_layer, jv.row_layer)


# ------------------------------------------------- the reduced models ----
def _routes(monkeypatch):
    """Record every router call's (probabilities, chosen experts) in both
    packages: the reference's through a debug callback (its scan traces
    the router)."""
    rec = {"j": [], "t": []}
    jtop, ttop = jax.lax.top_k, moe.top_k

    def jrec(probs, k):
        vals, idx = jtop(probs, k)
        jax.debug.callback(lambda p, i: rec["j"].append(
            (np.asarray(p), np.asarray(i))), probs, idx)
        return vals, idx

    def trec(probs, k):
        vals, idx = ttop(probs, k)
        rec["t"].append((probs.detach().float().numpy(), idx.numpy()))
        return vals, idx
    monkeypatch.setattr(jmoe.jax.lax, "top_k", jrec)
    monkeypatch.setattr(moe, "top_k", trec)
    return rec


def check_f32_loss_and_grad_match_reference(ref):
    cfg_j, cfg_t = ref["cfg"], ref["cfg_t"]
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, cfg_j), has_aux=True))
    (jtotal, jm), jg = vg(ref["params"], ref["batch"])
    params = tu.tree_map(lambda x: x.requires_grad_(True),
                         dense._port_params(ref["params"]))
    total, m = lm.lm_loss(params, dense._port_batch(ref["batch"]), cfg_t)
    grads = torch.autograd.grad(total, tu.leaves(params))
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    for k in ("loss", "moe_load_balance", "moe_z_loss"):
        assert float(m[k].detach()) != 0.0
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=1e-5,
                                   err_msg=k)
    dense._leafwise(tu.unflatten(tu.flatten(params)[1], list(grads)), jg,
                    F32_GRAD_TOL, "grad")


def check_bf16_routing_and_loss_match_reference(ref, monkeypatch):
    rec = _routes(monkeypatch)
    jtotal, _ = jlm.lm_loss(ref["params"], ref["batch"], ref["cfg"])
    with torch.no_grad():
        total, _ = lm.lm_loss(dense._port_params(ref["params"]),
                              dense._port_batch(ref["batch"]), ref["cfg_t"])
    n_moe = ref["cfg_t"].stack.segments[1][1]
    assert len(rec["j"]) == len(rec["t"]) == n_moe
    k = ref["cfg_t"].stack.moe.top_k
    for (pj, ej), (pt, et) in zip(rec["j"], rec["t"]):
        differ = (np.sort(ej, -1) != np.sort(et, -1)).any(-1)
        top = np.sort(pt, -1)[:, ::-1]
        gap = top[:, k - 1] - top[:, k]
        near = 2.0 * float(np.abs(pj - pt).max())
        assert np.all(gap[differ] <= near), (gap[differ], near)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-3)


@pytest.fixture(scope="module")
def ref():
    return make_ref("deepseek-v2-lite-16b")


@pytest.fixture(scope="module")
def ref32():
    return make_ref("deepseek-v2-lite-16b", f32=True)


def test_f32_loss_and_grad_match_reference(ref32):
    check_f32_loss_and_grad_match_reference(ref32)


def test_bf16_routing_and_loss_match_reference(ref, monkeypatch):
    check_bf16_routing_and_loss_match_reference(ref, monkeypatch)


def test_prefill_and_decode_match_reference(ref):
    dense.check_prefill_and_decode_past_the_ring_match_reference(ref)


def test_resident_step_matches_reference(ref32):
    dense.check_resident_step_matches_reference(ref32)


def test_registry_task_trains_on_the_cpu(ref):
    dense.check_registry_task_trains_on_the_cpu(ref)
