"""Port parity: EfficientNet-B0, the paper's second testbed
(``models.vision``, ``configs.efficientnet_b0``, the harness), against the
reference package, at narrow widths and then at full width.

Tolerances. Both sides run full f32 on the CPU and convolve in different
summation orders (XLA's and oneDNN's):
  * convolutions (k 5 at stride 2 over even and odd sizes, depthwise) and
    MBConv blocks in train and eval mode, with their BatchNorm running
    statistics: rtol 1e-5 / atol 1e-5;
  * the full train-mode loss at batch 2 within rtol 1e-5 (measured 1e-7),
    the BatchNorm statistics within rtol 1e-4 / atol 1e-6 (measured
    1.3e-5 past the atol: 16 blocks of f32 sums in two orders; the expand
    convs' batch means are cancellations of size 1e-8);
  * the gradient, born in slab layout in the port, leaf by leaf within
    1e-3 of the leaf's largest magnitude plus 1e-6 of the whole gradient's
    largest magnitude, against the port's forward evaluated in f64 (its
    BatchNorm still computes in f32, as ``bn_apply`` casts) and against the
    reference. Measured: the port 2.3e-4 off that evaluation, the
    reference's XLA-CPU gradient 1.7e-4 off it (unlike ResNet-18's first
    block, no leaf strays further), port against reference 1.5e-4. The
    absolute term covers the projections' BatchNorm biases (``bn2``):
    their exact gradient is zero (a per-channel shift before the next
    block's 1x1 expand and train-mode BatchNorm cancels), and each side
    computes f32 noise of up to 8e-7 there, against a largest gradient
    entry of 3.0.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.synthetic import CIFARLikeStream as JStream  # noqa: E402
from repro.kernels.layout import SlabView as JSlabView  # noqa: E402
from repro.models import vision as jv  # noqa: E402
from repro.models.vision import VisionConfig as JVisionConfig  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.train import paper_harness as jharness  # noqa: E402
from repro.train.task import VisionTask as JVisionTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import efficientnet_b0 as conf  # noqa: E402
from repro_torch.kernels.layout import SlabView  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402
from repro_torch.models.vision import VisionConfig  # noqa: E402
from repro_torch.train import paper_harness  # noqa: E402
from repro_torch.train.task import VisionTask, apply_codes  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = VisionConfig("efficientnet_b0")


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


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or TOL))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("case", [(16, 5, 2, 1), (15, 5, 2, 1),
                                  (16, 5, 2, 6), (15, 5, 2, 6),
                                  (8, 3, 1, 6), (8, 3, 2, 6), (16, 5, 1, 6)])
def test_conv_same_padding_k5_and_depthwise_match_reference(case):
    """A 5x5 stride-2 conv over an even size pads (1, 2) (16 -> 8), through
    ``F.pad``; depthwise kernels are HWIO (k, k, 1, C) with groups C."""
    size, k, stride, groups = case
    rng = np.random.default_rng(size * 100 + k * 10 + stride + groups)
    x = _rand(rng, 2, size, size, 6)
    cout = 6 if groups > 1 else 8
    w = _rand(rng, k, k, 6 // groups, cout, scale=0.3)
    want = jv.conv({"kernel": jnp.asarray(w)}, jnp.asarray(x), stride,
                   groups)
    got = tv.conv({"kernel": torch.from_numpy(w)}, torch.from_numpy(x),
                  stride, groups)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def _mbconv_params(rng, cin, cout, expand, k):
    mid, se = cin * expand, max(1, cin // 4)
    conv = lambda kk, ci, co: {"kernel": _rand(rng, kk, kk, ci, co,  # noqa
                                               scale=0.3)}
    bn = lambda c: ({"scale": _rand(rng, c) * 0.1 + 1.0,  # noqa: E731
                     "bias": _rand(rng, c) * 0.1},
                    {"mean": _rand(rng, c) * 0.1,
                     "var": np.abs(_rand(rng, c)) + 0.5})
    p, s = {}, {}
    if expand != 1:
        p["expand"] = conv(1, cin, mid)
        p["bn0"], s["bn0"] = bn(mid)
    p["dw"] = conv(k, 1, mid)
    p["bn1"], s["bn1"] = bn(mid)
    p["se_r"], p["se_e"] = conv(1, mid, se), conv(1, se, mid)
    p["project"] = conv(1, mid, cout)
    p["bn2"], s["bn2"] = bn(cout)
    return p, s


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("block", [(8, 4, 1, 3, 1), (4, 8, 6, 5, 2),
                                   (8, 8, 6, 3, 1)],
                         ids=["e1k3s1", "e6k5s2", "e6k3s1_residual"])
def test_mbconv_matches_reference(block, train):
    cin, cout, expand, k, stride = block
    rng = np.random.default_rng(cin * 10 + cout + k)
    p, s = _mbconv_params(rng, cin, cout, expand, k)
    # the port's init gives the same tree
    tp, ts = tv._mbconv_init(torch.Generator(), cin, cout, expand, k,
                             device="meta")
    assert [tuple(t.shape) for t in tu.leaves(tp)] == \
        [x.shape for x in jax.tree.leaves(p)]
    assert [tuple(t.shape) for t in tu.leaves(ts)] == \
        [x.shape for x in jax.tree.leaves(s)]
    x = _rand(rng, 2, 8, 8, cin)
    y, ns = jax.jit(jv._mbconv, static_argnums=(3, 4, 5, 6))(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s),
        jnp.asarray(x), stride, expand, train, 0.9)
    ty, tns = tv._mbconv(bridge.tree(p), bridge.tree(s), torch.from_numpy(x),
                         stride, expand, train, 0.9)
    assert tuple(ty.shape) == (2, 8 // stride, 8 // stride, cout)
    _close(ty, y)
    assert len(tu.leaves(tns)) == len(jax.tree.leaves(ns))
    for a, b in zip(tu.leaves(tns), jax.tree.leaves(ns)):
        _close(a, b)


def test_efficientnet_b0_init_shapes_and_order_match_reference():
    jtask = JVisionTask(JVisionConfig("efficientnet_b0"))
    pshape, sshape = jax.eval_shape(
        lambda k: jtask.init(k), jax.ShapeDtypeStruct((2,), jnp.uint32))
    pshape = split_params(pshape)[0]
    params, state = tv.vision_init(torch.Generator(), CFG, device="meta")
    flat = jax.tree_util.tree_flatten_with_path(pshape)[0]
    assert [tuple(str(getattr(k, "key", k)) for k in path)
            for path, _ in flat] == tu.paths(params)
    assert [tuple(s.shape) for _, s in flat] == \
        [tuple(t.shape) for t in tu.leaves(params)]
    assert [tuple(s.shape) for s in jax.tree.leaves(sshape)] == \
        [tuple(t.shape) for t in tu.leaves(state)]
    assert (len(tu.leaves(params)), len(tu.leaves(state))) == (181, 98)
    assert sum(t.numel() for t in tu.leaves(params)) == 4011018
    # a seeded init on the CPU: the fan-in scaled kernels, BN at (1, 0)
    p, s = tv.vision_init(torch.Generator().manual_seed(0), CFG)
    assert float(p["s1b0"]["dw"]["kernel"].std()) > 0
    assert torch.equal(p["s1b0"]["bn1"]["scale"], torch.ones(96))
    assert torch.equal(s["bn_head"]["var"], torch.ones(1280))
    # the registry and the config module
    assert "efficientnet_b0" in registry.PORTED
    assert "efficientnet_b0" not in registry.PENDING
    assert registry.get_model_config("efficientnet_b0") == CFG == \
        conf.config() == conf.reduced_config()
    assert set(conf.SKIP_SHAPES) == {"train_4k", "prefill_32k",
                                     "decode_32k", "long_500k"}
    with pytest.raises(ValueError, match="unknown vision model"):
        tv.vision_init(torch.Generator(), VisionConfig("efficientnet_b7"))


def test_apply_codes_rounds_every_top_level_block():
    """The in-loss QDQ acts on all 21 sorted top-level keys, block i at
    code i, every leaf of the block."""
    params, _ = tv.vision_init(torch.Generator(), CFG, device="meta")
    keys = sorted(params)
    assert len(keys) == 21 and keys[0] == "bn_head" and keys[-1] == "stem"
    seen = []
    out = apply_codes(params, list(range(21)), lambda w, c: seen.append(
        (tuple(w.shape), c)) or w, keys)
    assert seen == [(tuple(w.shape), i) for i, k in enumerate(keys)
                    for w in tu.leaves(params[k])]
    assert len(seen) == 181 and sorted(out) == keys


def test_memory_model_matches_reference():
    pshape = split_params(jax.eval_shape(
        lambda k: JVisionTask(JVisionConfig("efficientnet_b0")).init(k)[0],
        jax.ShapeDtypeStruct((2,), jnp.uint32)))[0]
    want = jharness.vision_memory_model(JVisionConfig("efficientnet_b0"),
                                        pshape)
    params, _ = tv.vision_init(torch.Generator(), CFG, device="meta")
    got = paper_harness.vision_memory_model(CFG, params)
    assert paper_harness.activation_elems(CFG) == \
        jharness.activation_elems(JVisionConfig("efficientnet_b0"))
    for b, codes in [(96, [2]), (32, [1]), (64, [1]), (16, [0, 1, 2])]:
        np.testing.assert_allclose(got.total(b, codes=codes),
                                   want.total(b, codes=codes), rtol=1e-12)
    # the paper's FP32 point is where the calibration puts it
    np.testing.assert_allclose(got.total(96, codes=[2]), 0.301e9, rtol=1e-9)


def test_efficientnet_b0_loss_and_slab_gradient_match_reference():
    jtask = JVisionTask(JVisionConfig("efficientnet_b0"))
    wrapped, jaux = jax.jit(jtask.init)(jax.random.PRNGKey(0))
    jparams = split_params(wrapped)[0]
    batch = JStream(global_batch=2, seed=4).batch(0)

    def loss_fn(p):
        loss, aux, _ = jtask.loss(p, jaux, batch, None, None)
        return loss, aux

    (jloss, jnew_aux), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    jview = JSlabView.build(jparams, jtask.grouping(jparams))

    task = VisionTask(CFG, device="cpu")
    params = bridge.tree(jax.device_get(jparams))
    aux = bridge.tree(jax.device_get(jaux))
    view = SlabView.build(params, task.grouping(params))
    slab = view.pack(params).requires_grad_(True)
    tb = {k: bridge.tensor(v) for k, v in jax.device_get(batch).items()}
    loss, new_aux, _ = task.loss(view.unpack(slab, like=params), aux, tb,
                                 None, None)
    (g,) = torch.autograd.grad(loss, slab)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for a, b in zip(tu.leaves(new_aux), jax.tree.leaves(jnew_aux)):
        _close(a, b, rtol=1e-4, atol=1e-6)
    assert g.shape == (jview.rows, 512) == (7936, 512)
    assert view.num_layers == jview.num_layers == 21
    tgrads = view.unpack(g, like=params)
    assert torch.equal(view.pack(tgrads), g)

    # the port's own forward with f64 inputs: its f32 gradient's accuracy
    p64 = tu.tree_map(lambda t: t.double().requires_grad_(True), params)
    logits, _ = tv.vision_apply(p64, tu.tree_map(lambda t: t.double(), aux),
                                tb["images"].double(), True, CFG)
    one = torch.nn.functional.one_hot(tb["labels"].long(), CFG.num_classes)
    l64 = -(one * torch.log_softmax(logits, -1)).sum(-1).mean()
    g64 = [e.numpy() for e in torch.autograd.grad(l64, tu.leaves(p64))]
    floor = 1e-6 * max(np.abs(e).max() for e in g64)

    paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for (path, jg), tg, eg in zip(paths, tu.leaves(tgrads), g64):
        name = jax.tree_util.keystr(path)
        jg, tg = np.asarray(jg), tg.numpy()
        bound = 1e-3 * np.abs(eg).max() + floor
        assert np.abs(tg - eg).max() <= bound, name
        assert np.abs(tg - jg).max() <= bound, name


@pytest.mark.parametrize("method", ["triaccel", "fp32"])
def test_run_method_efficientnet_b0_on_cpu(method):
    """The harness end to end at batch 4: the resident fused step
    (Tri-Accel) or the reference step (FP32) over EfficientNet-B0's 21
    layers."""
    res = paper_harness.run_method(method, "efficientnet_b0", steps=2,
                                   batch0=4, device="cpu")
    assert res.arch == "efficientnet_b0" and len(res.log) == 2
    assert all(np.isfinite(m["loss"]) and m["grads_finite"] == 1.0
               for m in res.log)
    assert len(res.codes) == 21 and len(res.curvature) == 21
    assert 0.0 <= res.accuracy <= 100.0 and res.measured_bytes == {}
    if method == "fp32":
        assert res.codes == [2] * 21
        assert res.final_batch == 4 and res.batch_history == []
    else:
        assert set(res.codes) <= {0, 1, 2}
        assert res.final_batch in (2, 4, 6, 8)
    trainer = paper_harness.make_trainer(method, "efficientnet_b0", steps=2,
                                         batch0=4, device="cpu")[0]
    assert trainer.resident == (method == "triaccel")
    if trainer.resident:
        assert trainer.view.rows == 7936
