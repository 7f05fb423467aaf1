"""Port parity of the tier cast's output type: ``ops.qdq_cast(...,
out_dtype=torch.bfloat16)`` on CPU tensors (the plain version) against the
reference's ``qdq_cast(...).astype(jnp.bfloat16)`` (its Pallas kernel in
interpret mode on the CPU), on the same numpy inputs; and the serving
weight sets (``serve.engine.tier_params``, whose tier 0 now asks the cast
for bf16 directly) against the reference's at tiers 0, 1 and 2, with and
without a per-leaf ``amax_tree``.

Tolerance: bitwise, NaN equal to NaN (elementwise rounding, one exact max,
and one f32 -> bf16 round to nearest even on each side). Covered: both
ladders, f32 and bf16 inputs, codes 0/1/2, sizes 0, 1, 7, 8, 9, 17, one
(256, 512) tile and a ragged size, with no ``amax``, a given one, and one
too small for the tensor (|x * 448/amax| past 464: NaN, as the reference's
fp8 cast gives). The reference's Pallas call takes no empty tensor, so at
size 0 only the shape and type are checked.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import qdq_cast as qc  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from test_torch_dense_archs import _one_intra_op_thread  # noqa: E402, F401

SIZES = {"0": (0,), "1": (1,), "7": (7,), "8": (8,), "9": (9,),
         "17": (17,), "tile": (256, 512), "ragged": (37, 53)}


def _inputs(shape, dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    flat = x.reshape(-1)
    edges = [7e4, -1e-30, 448.0, 2.5e-8, -0.0, 12.0]     # fp16 over/under
    flat[:min(len(edges), flat.size)] = edges[:flat.size]
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    return xj, bridge.tensor(np.asarray(xj))


def _same(port: torch.Tensor, ref) -> bool:
    a = port.float().numpy()
    b = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    nan = np.isnan(a) & np.isnan(b)
    return a.shape == b.shape and bool(
        ((a.view(np.int32) == b.view(np.int32)) | nan).all())


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ladder", ["tpu", "gpu"])
def test_qdq_cast_bf16_output_matches_reference_cast(ladder, dtype, size):
    xj, xt = _inputs(SIZES[size], dtype)
    for amax in (None, 9.5, 0.5):
        am_t = None if amax is None else torch.tensor(amax)
        for code in (0, 1, 2):
            got = ops.qdq_cast(xt, code, ladder, am_t,
                               out_dtype=torch.bfloat16)
            assert got.dtype == torch.bfloat16 and got.shape == xt.shape
            if xt.numel() == 0:
                continue
            am_j = None if amax is None else jnp.float32(amax)
            ref = jops.qdq_cast(xj, jnp.int32(code), ladder=ladder,
                                amax=am_j).astype(jnp.bfloat16)
            assert _same(got, ref), (ladder, dtype, size, amax, code)
            # one cast after the f32 cast, as the serving path did before
            chain = ops.qdq_cast(xt.float(), code, ladder,
                                 am_t).to(torch.bfloat16)
            assert torch.equal(got.view(torch.int16),
                               chain.view(torch.int16))


def test_qdq_cast_out_dtype_defaults_to_the_input_type():
    x = torch.randn(33) * 5
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        assert ops.qdq_cast(xd, 0).dtype == dtype
        assert torch.equal(ops.qdq_cast(xd, 0, out_dtype=dtype),
                           ops.qdq_cast(xd, 0))
    wide = ops.qdq_cast(x.to(torch.bfloat16), 1, out_dtype=torch.float32)
    assert wide.dtype == torch.float32
    assert torch.equal(wide, x.to(torch.bfloat16).float())


@pytest.mark.parametrize("code", [0, 1, 2])
@pytest.mark.parametrize("ladder", ["tpu", "gpu"])
def test_form_names_the_kernel_that_runs(ladder, code):
    """The two-pass form only where the tpu ladder's code 0 needs the
    tensor's own absmax; every other call reads none or is given one."""
    two = ladder == "tpu" and code == 0
    assert qc.form(code, ladder, None) == ("two_pass" if two else "one_pass")
    assert qc.form(code, ladder, torch.tensor(1.0)) == "one_pass"


def _tree(seed=2):
    """A params-shaped tree: f32 and bf16 leaves, a stacked (layers, ...)
    leaf, a norm scale and an integer leaf (left as it is)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)  # noqa
    tree = {"emb": f(61, 24), "norm": np.ones(24, np.float32) + f(24),
            "stack": {"w": f(3, 24, 40), "b": f(3, 40)},
            "steps": np.arange(5, dtype=np.int32)}
    tree["stack"]["w"][1, 2, 3] = 9.0
    pj = jax.tree.map(jnp.asarray, tree)
    pj["half"] = jnp.asarray(f(17, 9)).astype(jnp.bfloat16)
    return pj, tu.tree_map(bridge.tensor, jax.device_get(pj))


@pytest.mark.parametrize("with_amax", [False, True])
def test_tier_params_match_reference_bitwise_at_every_tier(with_amax):
    """Tiers 0, 1 and 2 of ``tier_params`` equal the reference's, leaf for
    leaf and bit for bit; tier 0 with a per-leaf ``amax_tree`` too (one
    absmax per leaf, here a little above each leaf's own)."""
    pj, pt = _tree()
    amax_j = amax_t = None
    if with_amax:
        amax_j = jax.tree.map(
            lambda x: jnp.max(jnp.abs(x.astype(jnp.float32))) * 1.0625, pj)
        amax_t = tu.tree_map(lambda x: bridge.tensor(np.asarray(x)),
                             jax.device_get(amax_j))
    for tier in (0, 1, 2):
        want = jax.device_get(jengine.tier_params(pj, tier, "tpu",
                                                  amax_tree=amax_j))
        got = engine.tier_params(pt, tier, "tpu", amax_tree=amax_t)
        for w, g in zip(jax.tree.leaves(want), tu.leaves(got)):
            w = np.asarray(w)
            assert str(g.dtype) == f"torch.{w.dtype}", tier
            g = bridge.to_numpy(g)
            assert w.shape == g.shape, tier
            assert (w.view(np.uint8) == g.view(np.uint8)).all(), tier
