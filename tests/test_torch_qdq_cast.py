"""Port parity: the plain PyTorch tier cast (``repro_torch.kernels.ops
.qdq_cast`` on CPU tensors) against the reference's Pallas kernel
(``repro.kernels.ops.qdq_cast``, interpret mode on the CPU), on the same
numpy inputs.

Tolerance: bitwise, NaN equal to NaN (the cast is elementwise rounding and
one exact max). Covered: both ladders, codes 0/1/2, f32 and bf16, a size
that fills whole (256, 512) tiles and a ragged one, with and without a
given ``amax``, and a given ``amax`` too small for the tensor, where
|x * 448/amax| passes 464 and the reference's fp8 cast gives NaN (torch's
own cast would saturate).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SHAPES = {"tiles": (512, 512), "ragged": (37, 53)}


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    flat = x.reshape(-1)
    flat[:6] = [1e-30, -0.0, 70000.0, -7e4, 2.5e-8, 448.0]  # fp16 over/under
    flat[-1] = 12.0                                          # the absmax
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    return xj, bridge.tensor(np.asarray(xj))


def _same(port: torch.Tensor, ref) -> bool:
    a = port.float().numpy()
    b = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    nan = np.isnan(a) & np.isnan(b)
    return bool(((a.view(np.int32) == b.view(np.int32)) | nan).all())


@pytest.mark.parametrize("amax", [None, 9.5])
@pytest.mark.parametrize("size", sorted(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ladder", ["tpu", "gpu"])
def test_qdq_cast_plain_matches_reference(ladder, dtype, size, amax):
    xj, xt = _inputs(SHAPES[size], dtype)
    am_j = None if amax is None else jnp.float32(amax)
    am_t = None if amax is None else torch.tensor(amax)
    for code in (0, 1, 2):
        ref = jops.qdq_cast(xj, jnp.int32(code), ladder=ladder, amax=am_j)
        got = ops.qdq_cast(xt, code, ladder=ladder, amax=am_t)
        assert got.dtype == xt.dtype and got.shape == xt.shape
        assert _same(got, ref), (ladder, dtype, size, amax, code)


def test_qdq_cast_small_amax_gives_nan_like_reference():
    """amax 4 for a tensor whose absmax is 12: scale 112, so |x| > 4.14
    lands past 464 and rounds to NaN, |x| in (4, 4.14] to 448/112 = 4."""
    x = np.array([[0.5, -4.0, 4.1, 4.2, -5.0, 12.0, -12.0, 4.142857]],
                 np.float32)
    ref = jops.qdq_cast(jnp.asarray(x), jnp.int32(0), ladder="tpu",
                        amax=jnp.float32(4.0))
    got = ops.qdq_cast(torch.from_numpy(x), 0, ladder="tpu",
                       amax=torch.tensor(4.0))
    assert _same(got, ref)
    assert np.isnan(got.numpy()[0, 3:7]).all()
    assert not np.isnan(got.numpy()[0, :3]).any()


@pytest.mark.parametrize("amax", [0.27, 1.7, 0.2712345])
@pytest.mark.parametrize("given", [False, True])
def test_qdq_cast_scale_is_a_true_division(amax, given):
    """448/amax rounded once, as the reference divides: for these absmax
    values torch's ``448.0 / tensor`` (a reciprocal, then a multiply) lands
    one ulp away, and the whole tensor would round to another grid."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((64, 64)) * amax / 4).astype(np.float32)
    x = np.clip(x, -amax, amax)
    x[0, 0] = amax
    am_j = jnp.float32(amax) if given else None
    am_t = torch.tensor(amax) if given else None
    ref = jops.qdq_cast(jnp.asarray(x), jnp.int32(0), ladder="tpu",
                        amax=am_j)
    got = ops.qdq_cast(torch.from_numpy(x), 0, ladder="tpu", amax=am_t)
    assert _same(got, ref)
