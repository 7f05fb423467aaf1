"""Port parity: the ResNet-18 testbed (``models.vision``, ``train.task``)
against the reference package, at narrow widths and then at full width.

Both run full f32 on the CPU and convolve in different summation orders
(XLA's and oneDNN's), so activations are held within rtol 1e-5 / atol 1e-5,
and BatchNorm's running statistics likewise. The full ResNet-18 train-mode
loss at batch 2 is held within rtol 1e-5. Its gradient, born in slab
layout in the port, is held leaf by leaf against an f64 evaluation of the
port's own forward (within 2e-5 of the leaf's largest magnitude) and
against the reference: within 2e-4 of the leaf's largest magnitude, except
in the stem and the first residual block (the 32x32 feature maps), where
the reference's XLA-CPU gradient itself strays from the f64 values by up to
1.7e-2 of the leaf's largest magnitude (measured), and the bound is 3e-2.
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
from repro.train.task import VisionTask as JVisionTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.kernels.layout import SlabView  # noqa: E402
from repro_torch.models import vision as tv  # noqa: E402
from repro_torch.models.vision import VisionConfig  # noqa: E402
from repro_torch.train.task import VisionTask  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or TOL))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("case", [(8, 3, 1), (8, 3, 2), (7, 3, 2), (8, 1, 2),
                                  (7, 1, 1)])
def test_conv_same_padding_matches_reference(case):
    """Even sizes at stride 2 pad (0, 1) as JAX's "SAME" does."""
    size, k, stride = case
    rng = np.random.default_rng(size * 10 + k + stride)
    x = _rand(rng, 2, size, size, 3)
    w = _rand(rng, k, k, 3, 8, scale=0.3)
    want = jv.conv({"kernel": jnp.asarray(w)}, jnp.asarray(x), stride)
    got = tv.conv({"kernel": torch.from_numpy(w)}, torch.from_numpy(x),
                  stride)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("train", [True, False])
def test_bn_apply_matches_reference(train):
    rng = np.random.default_rng(5)
    x = _rand(rng, 4, 5, 5, 6, scale=2.0) + 0.5
    p = {"scale": _rand(rng, 6) + 1.0, "bias": _rand(rng, 6)}
    s = {"mean": _rand(rng, 6) * 0.1, "var": np.abs(_rand(rng, 6)) + 0.5}
    y, ns = jv.bn_apply(jax.tree.map(jnp.asarray, p),
                        jax.tree.map(jnp.asarray, s), jnp.asarray(x), train,
                        0.9)
    ty, tns = tv.bn_apply(bridge.tree(p), bridge.tree(s), torch.from_numpy(x),
                          train, 0.9)
    _close(ty, y)
    for k in ("mean", "var"):
        _close(tns[k], ns[k])


@pytest.mark.parametrize("train", [True, False])
def test_basic_block_with_proj_matches_reference(train):
    rng = np.random.default_rng(6)
    cin, cout = 4, 8
    conv = lambda k, ci: {"kernel": _rand(rng, k, k, ci, cout, scale=0.3)}
    bn = lambda: ({"scale": _rand(rng, cout) + 1.0, "bias": _rand(rng, cout)},
                  {"mean": _rand(rng, cout) * 0.1,
                   "var": np.abs(_rand(rng, cout)) + 0.5})
    p = {"conv1": conv(3, cin), "conv2": conv(3, cout), "proj": conv(1, cin)}
    s = {}
    for k in ("bn1", "bn2", "bnp"):
        p[k], s[k] = bn()
    x = _rand(rng, 2, 8, 8, cin)
    y, ns = jax.jit(jv._basic_block, static_argnums=(3, 4, 5))(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s),
        jnp.asarray(x), 2, train, 0.9)
    ty, tns = tv._basic_block(bridge.tree(p), bridge.tree(s),
                              torch.from_numpy(x), 2, train, 0.9)
    _close(ty, y)
    for a, b in zip(tu.leaves(tns), jax.tree.leaves(ns)):
        _close(a, b)


def test_resnet18_init_shapes_match_reference():
    jtask = JVisionTask(JVisionConfig("resnet18"))
    shapes = split_params(jax.eval_shape(
        lambda k: jtask.init(k)[0], jax.ShapeDtypeStruct((2,), jnp.uint32)
    ))[0]
    params, state = tv.vision_init(torch.Generator().manual_seed(0),
                                   VisionConfig("resnet18"), device="meta")
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert [tuple(s.shape) for _, s in flat] == \
        [tuple(t.shape) for t in tu.leaves(params)]
    assert len(tu.leaves(state)) == 2 * 20
    with pytest.raises(NotImplementedError, match="not ported"):
        tv.vision_init(torch.Generator(), VisionConfig("efficientnet_b0"))


def test_resnet18_loss_and_slab_gradient_match_reference():
    jtask = JVisionTask(JVisionConfig("resnet18"))
    wrapped, jaux = jax.jit(jtask.init)(jax.random.PRNGKey(0))
    jparams = split_params(wrapped)[0]
    batch = JStream(global_batch=2, seed=4).batch(0)

    def loss_fn(p):
        loss, aux, _ = jtask.loss(p, jaux, batch, None, None)
        return loss, aux

    (jloss, jnew_aux), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    jview = JSlabView.build(jparams, jtask.grouping(jparams))

    task = VisionTask(VisionConfig("resnet18"), device="cpu")
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
        _close(a, b, rtol=1e-5, atol=1e-6)
    assert g.shape == (jview.rows, 512) == (22016, 512)
    tgrads = view.unpack(g, like=params)
    # one slab holds every leaf's gradient in its rows, zeros in the lane
    # and tail pad
    assert torch.equal(view.pack(tgrads), g)

    # the port's own forward in f64: its f32 gradient's accuracy
    p64 = tu.tree_map(lambda t: t.double().requires_grad_(True), params)
    cfg = task.cfg
    logits, _ = tv.vision_apply(p64, tu.tree_map(lambda t: t.double(), aux),
                                tb["images"].double(), True, cfg)
    one = torch.nn.functional.one_hot(tb["labels"].long(), cfg.num_classes)
    l64 = -(one * torch.log_softmax(logits, -1)).sum(-1).mean()
    g64 = torch.autograd.grad(l64, tu.leaves(p64))

    paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for (path, jg), tg, eg in zip(paths, tu.leaves(tgrads), g64):
        name = jax.tree_util.keystr(path)
        jg, tg, eg = np.asarray(jg), tg.numpy(), eg.numpy()
        scale = np.abs(eg).max()
        assert np.abs(tg - eg).max() <= 2e-5 * scale, name
        first = name.startswith(("['stem']", "['bn_stem']", "['s0b0']"))
        bound = (3e-2 if first else 2e-4) * scale
        assert np.abs(tg - jg).max() <= bound, name
