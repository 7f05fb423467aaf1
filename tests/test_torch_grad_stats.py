"""Port parity for B4 ``grad_stats`` and the reference's tile folding:
``repro_torch.kernels.ops.grad_stats`` (the plain version on the CPU)
against the reference's ``repro.kernels.ops.grad_stats`` (its Pallas
kernel in interpret mode, as the reference's own tests run it) and its
oracle ``repro.kernels.ref.grad_stats_ref``, on the same numpy inputs; and
``layout.fold2d``/``small_blocks`` against the reference's over a sweep of
sizes. The card-only checks (the CUDA kernel against this plain version)
are in ``tests/test_torch_cuda_kernels.py``.

Tolerances:
  * the port's sums (sum and sum of squares) within 2^-20 of the sum of
    the terms' magnitudes of an f64 sum of the same f32 values: f32 sums in
    another order, held to the conditioning of the sum rather than to its
    possibly near-zero value; the reference's (its kernel's and its
    oracle's) within 2^-18 of the same, since XLA-CPU's own f32 sums of
    squares of bf16 inputs stray up to 1.43 x 2^-20 (measured over these
    shapes), so port and reference agree within 2^-20 + 2^-18;
  * the absmax bitwise (a max is exact in any order);
  * non-finite inputs: each statistic in the same class (NaN, +inf, -inf)
    as the reference's;
  * fold2d and small_blocks equal.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import layout as jlayout  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import grad_stats as gs  # noqa: E402
from repro_torch.kernels import layout  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SHAPES = [(64,), (513, 129), (1024, 512), (7, 3, 5), (8,), (300,), (1000,)]
SIZES = [0, 1, 15, 16, 127, 128, 4095, 4096, 131071, 131072, 131073,
         1_000_000]


def _input(shape, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x * 2).astype(dtype)


def _f64_truth(x):
    """f64 (sum, sum_sq) of the f32 values, and their magnitudes' sums."""
    v = np.asarray(x, np.float32).astype(np.float64)
    return (v.sum(), (v * v).sum()), (np.abs(v).sum(), (v * v).sum())


def _check_sums(got, x, rel=2.0 ** -20):
    (s, ss), (ms, mss) = _f64_truth(x)
    assert abs(float(got[0]) - s) <= rel * ms, (float(got[0]), s)
    assert abs(float(got[1]) - ss) <= rel * mss, (float(got[1]), ss)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_stats_matches_reference(shape, dtype):
    x = _input(shape, getattr(jnp, dtype))
    got = ops.grad_stats(bridge.tensor(jax.device_get(x)))
    assert all(t.dtype == torch.float32 and t.dim() == 0 for t in got)
    want = jops.grad_stats(x)
    oracle = jref.grad_stats_ref(x)
    _check_sums(got, x)
    for trio in (want, oracle):
        _check_sums(trio, x, rel=2.0 ** -18)
    for other in (want, oracle):
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(other[2]))


def test_grad_stats_of_an_empty_tensor_is_zero():
    got = ops.grad_stats(torch.zeros((0,), dtype=torch.float32))
    want = jops.grad_stats(jnp.zeros((0,), jnp.float32))
    assert [float(t) for t in got] == [float(t) for t in want] == [0.0] * 3


def _cls(v):
    v = float(v)
    return "nan" if np.isnan(v) else ("+inf" if v == np.inf else
                                      ("-inf" if v == -np.inf else "finite"))


@pytest.mark.parametrize("bad", [["nan"], ["+inf"], ["-inf"],
                                 ["+inf", "-inf"], ["nan", "+inf"]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_stats_non_finite_agrees_in_class(bad, dtype):
    x = np.array(_input((513, 129), jnp.float32, seed=1), np.float32)
    vals = {"nan": np.nan, "+inf": np.inf, "-inf": -np.inf}
    for i, b in enumerate(bad):
        x.reshape(-1)[1000 * (i + 1)] = vals[b]
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = ops.grad_stats(bridge.tensor(jax.device_get(xj)))
    for want in (jops.grad_stats(xj), jref.grad_stats_ref(xj)):
        assert [_cls(t) for t in got] == [_cls(t) for t in want]
    assert _cls(got[2]) in ("nan", "+inf")


def test_grad_stats_flattens_a_non_contiguous_tensor():
    x = _input((300, 77), jnp.float32, seed=2)
    t = bridge.tensor(jax.device_get(x))
    got = ops.grad_stats(t.T)
    assert not t.T.is_contiguous()
    want = jref.grad_stats_ref(x)
    _check_sums(got, x)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_grad_stats_plain_version_is_the_reference_oracle():
    """``grad_stats_ref`` is the oracle's arithmetic: f32 sums of x and
    x*x and the amax of |x|, in torch's order."""
    x = torch.randn((1000, 3), generator=torch.Generator().manual_seed(0))
    s, ss, mx = gs.grad_stats_ref(x.to(torch.bfloat16))
    xf = x.to(torch.bfloat16).float()
    assert torch.equal(s, xf.sum()) and torch.equal(ss, (xf * xf).sum())
    assert torch.equal(mx, xf.abs().amax())


@pytest.mark.parametrize("n", SIZES)
def test_small_blocks_matches_reference(n):
    assert layout.small_blocks(n) == jlayout.small_blocks(n)
    assert layout.small_blocks(n, 64, 256) == jlayout.small_blocks(n, 64, 256)


@pytest.mark.parametrize("n", SIZES)
def test_fold2d_matches_reference(n):
    x = np.arange(n, dtype=np.float32) - n / 2
    bm, bn = jlayout.small_blocks(n)
    for min_rows in (0, bm):
        want = np.asarray(jlayout.fold2d(jnp.asarray(x), bm, bn, min_rows))
        got = layout.fold2d(torch.from_numpy(x), bm, bn, min_rows)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_fold2d_reshapes_an_aligned_tensor_in_place():
    x = torch.zeros((1024, 512))
    assert layout.fold2d(x, 256, 512).data_ptr() == x.data_ptr()
    y = torch.zeros((1000, 37))
    assert layout.fold2d(y, 256, 512).data_ptr() != y.data_ptr()
