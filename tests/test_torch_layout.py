"""Port parity: ``repro_torch.kernels.layout.SlabView`` against the
reference ``repro.kernels.layout.SlabView`` — the same rows, per-row layer
ids and leaf slots for ResNet-18, EfficientNet-B0 (shapes only) and a toy
tree, and a bitwise pack/unpack round trip."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.grouping import flat_grouping as jflat_grouping  # noqa: E402
from repro.kernels.layout import SlabView as JSlabView  # noqa: E402
from repro.models.vision import VisionConfig as JVisionConfig  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.train.task import VisionTask as JVisionTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.core.grouping import flat_grouping  # noqa: E402
from repro_torch.kernels.layout import SlabView  # noqa: E402


def _vision_shapes(name):
    task = JVisionTask(JVisionConfig(name))
    wrapped = jax.eval_shape(lambda k: task.init(k)[0],
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    return split_params(wrapped)[0]


def _toy_shapes():
    sds = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    return {"lin": {"w": sds(96, 32), "b": sds(32)}, "head": {"w": sds(32, 8)}}


def _meta(shape_tree):
    return jax.tree.map(
        lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"),
        shape_tree)


def _views(shape_tree):
    ref = JSlabView.build(shape_tree, jflat_grouping(shape_tree))
    meta = _meta(shape_tree)
    port = SlabView.build(meta, flat_grouping(meta))
    return ref, port


@pytest.mark.parametrize("which", ["resnet18", "efficientnet_b0", "toy"])
def test_layout_matches_reference(which):
    shapes = _toy_shapes() if which == "toy" else _vision_shapes(which)
    ref, port = _views(shapes)
    assert port.rows == ref.rows
    assert port.num_layers == ref.num_layers
    np.testing.assert_array_equal(port.row_layer, ref.row_layer)
    assert len(port.slots) == len(ref.slots)
    for a, b in zip(port.slots, ref.slots):
        assert (a.shape, a.floating, a.stack, a.elems, a.rows_per,
                a.row_off, a.layers) == (b.shape, b.floating, b.stack,
                                         b.elems, b.rows_per, b.row_off,
                                         b.layers)
    if which == "resnet18":
        # the slice's shape: 11,173,962 params in 62 leaves, 11 layers,
        # 22,016 rows (86 tiles of 256)
        assert (port.rows, port.num_layers, len(port.slots)) == (22016, 11,
                                                                 62)
        assert sum(int(np.prod(s.shape)) for s in port.slots) == 11173962


@pytest.mark.parametrize("which", ["resnet18", "toy"])
def test_pack_unpack_round_trip_bitwise(which):
    shapes = _toy_shapes() if which == "toy" else _vision_shapes(which)
    rng = np.random.default_rng(0)
    vals = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    ref, _ = _views(shapes)
    port_params = bridge.tree(vals)
    port = SlabView.build(port_params, flat_grouping(port_params))
    slab = port.pack(port_params)
    # the port's slab is the reference's, element for element
    want = np.asarray(ref.pack(jax.tree.map(jnp.asarray, vals)))
    np.testing.assert_array_equal(slab.numpy(), want)
    back = port.unpack(slab, like=port_params)
    for a, b in zip(jax.tree.leaves(vals),
                    [t.numpy() for t in tu.leaves(back)]):
        np.testing.assert_array_equal(a, b)
    # bf16 slab: pack casts, unpack returns the cast values bitwise
    s16 = port.pack(port_params, torch.bfloat16)
    back16 = port.unpack(s16, like=port_params)
    for a, b in zip(tu.leaves(port_params),
                    tu.leaves(back16)):
        assert torch.equal(a.to(torch.bfloat16), b)


def test_unpack_gradient_is_born_in_slab_layout():
    """Autograd through ``unpack`` returns ONE slab gradient: each leaf's
    cotangent in its rows, zeros in the lane and tail pad."""
    shapes = _toy_shapes()
    port_params = bridge.tree(jax.tree.map(
        lambda s: np.ones(s.shape, np.float32), shapes))
    view = SlabView.build(port_params, flat_grouping(port_params))
    slab = view.pack(port_params).requires_grad_(True)
    tree = view.unpack(slab, like=port_params)
    loss = sum((l * (i + 1)).sum()
               for i, l in enumerate(tu.leaves(tree)))
    (g,) = torch.autograd.grad(loss, slab)
    assert g.shape == slab.shape
    # sorted leaf order: head.w, lin.b, lin.w -> weights 1, 2, 3
    want = view.pack(bridge.tree({"head": {"w": np.full((32, 8), 1.0,
                                                         np.float32)},
                                  "lin": {"b": np.full((32,), 2.0,
                                                       np.float32),
                                          "w": np.full((96, 32), 3.0,
                                                       np.float32)}}))
    assert torch.equal(g, want)
