"""Port parity for ``nn.layers``' activations and LayerNorm against the
reference's (``repro/nn/layers.py``), on the same numpy inputs.

  * The names: the reference's five (``silu``, ``gelu``, ``relu``,
    ``relu2``, ``gelu_tanh``) and nothing else (both raise ``KeyError``).
    The reference's ``gelu`` is ``jax.nn.gelu``'s default, the tanh form,
    so ``gelu`` and ``gelu_tanh`` are one function in both packages.
  * bf16, every one of the 65,536 bit patterns: bitwise, NaN equal to
    NaN. The port repeats XLA's operations one rounding each (the
    logistic as 1 / (1 + exp(-x)), the cube as x * x * x, the constants
    rounded to bf16 first). Two things are not the function and are left
    out: XLA on the CPU flushes subnormals to zero, inputs, intermediates
    and results, where torch keeps them, so where the input or the port's
    result is subnormal, or the reference's result is a zero that the
    flush made (port below 2^-100 in magnitude: an underflowed
    intermediate), the two must only agree within 2^-100; and relu(-0.0)
    is +0.0 in XLA and -0.0 in torch, so zeros compare by value.
  * f32 on 2^18 normal draws (sd 4) and a grid over [-30, 30]: relu and
    relu2 bitwise (zeros by value); silu and gelu within 2^-21 |x|: exp
    and tanh come from two libraries (tanh up to 5 ulp apart), and gelu's
    1 + tanh cancels for negative x, so the gap scales with x and not
    with the result (measured 3.95 x 2^-24 |x|).
  * The f32 gradients (``jax.grad`` against autograd) on the same
    inputs: relu and relu2 bitwise (0 at 0 in both), silu and gelu within
    2^-19 (1 + |x|) (measured 6.4e-7 (1 + |x|)).
  * LayerNorm (eps 1e-5, scale and bias), (64, 256) rows of sd 3 around
    0.5: f32 within 2^-18 of each element's terms, (|x| + |mean|) / sd
    x |scale| + |bias|. x - mean cancels, and the two packages sum the
    mean and the variance in other orders: both sides stray from an f64
    evaluation by up to ~70 x 2^-24 of those terms (measured 37 and 68);
    bf16 inputs bitwise (the f32 gap flips a bf16 rounding only that near
    a tie: 0 of the 16,384 here). ``layernorm_init``: ones and zeros.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.nn import layers as jl  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.nn import layers as tl  # noqa: E402

NAMES = ["silu", "gelu", "relu", "relu2", "gelu_tanh"]
BF16_TINY = float(ml_dtypes.finfo(ml_dtypes.bfloat16).tiny)


def _f32_inputs():
    rng = np.random.default_rng(0)
    return np.concatenate([
        rng.standard_normal(1 << 18).astype(np.float32) * 4,
        np.linspace(-30, 30, 60001, dtype=np.float32)])


def test_activation_names_match_reference():
    for name in NAMES:
        assert callable(tl.activation(name)) and callable(
            jl.activation(name))
    assert tl.activation("gelu") is tl.activation("gelu_tanh")
    for mod in (tl, jl):
        with pytest.raises(KeyError):
            mod.activation("swish")


@pytest.mark.parametrize("name", NAMES)
def test_activation_bf16_bitwise_every_value(name):
    x = np.arange(1 << 16, dtype=np.uint16).view(ml_dtypes.bfloat16)
    want = np.asarray(jax.jit(jl.activation(name))(jnp.asarray(x)))
    got = tl.activation(name)(bridge.tensor(x)).view(torch.uint16).numpy()
    want = want.astype(np.float32)
    got = got.view(ml_dtypes.bfloat16).astype(np.float32)
    xf = x.astype(np.float32)

    def sub(v):
        return (np.abs(v) < BF16_TINY) & (v != 0)
    flushed = (sub(xf) | sub(got)
               | ((want == 0) & (got != 0) & (np.abs(got) < 2.0 ** -100)))
    nan = np.isnan(want) & np.isnan(got)
    exact = (got == want) | nan
    assert exact[~flushed].all(), xf[~flushed & ~exact][:8]
    assert (np.abs(got[flushed] - want[flushed]) <= 2.0 ** -100).all()
    assert flushed.sum() < 1024                  # the subnormal band only


@pytest.mark.parametrize("name", NAMES)
def test_activation_f32_and_gradient(name):
    x = _f32_inputs()
    fj = jl.activation(name)
    want = np.asarray(jax.jit(fj)(jnp.asarray(x))).astype(np.float64)
    gwant = np.asarray(jax.jit(jax.vmap(jax.grad(fj)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tl.activation(name)(xt)
    (ggot,) = torch.autograd.grad(y.sum(), xt)
    got = y.detach().numpy().astype(np.float64)
    ggot = ggot.numpy()
    if name in ("relu", "relu2"):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ggot, gwant)
        return
    assert (np.abs(got - want) <= 2.0 ** -21 * np.abs(x)).all()
    assert (np.abs(ggot.astype(np.float64) - gwant)
            <= 2.0 ** -19 * (1 + np.abs(x))).all()


def _ln_inputs(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 256)) * 3 + 0.5).astype(dtype)
    p = {"scale": (1 + 0.1 * rng.standard_normal(256)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(256)).astype(np.float32)}
    return x, p


def test_layernorm_f32_matches_reference():
    x, p = _ln_inputs(np.float32)
    want = np.asarray(jl.layernorm(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x))).astype(np.float64)
    got = tl.layernorm(bridge.tree(p), torch.from_numpy(x)).numpy()
    x64 = x.astype(np.float64)
    mu = x64.mean(-1, keepdims=True)
    sd = np.sqrt(((x64 - mu) ** 2).mean(-1, keepdims=True) + 1e-5)
    terms = (np.abs(x64) + np.abs(mu)) / sd * np.abs(p["scale"]) + \
        np.abs(p["bias"])
    assert (np.abs(got - want) <= 2.0 ** -18 * terms).all()


def test_layernorm_bf16_bitwise():
    x, p = _ln_inputs(ml_dtypes.bfloat16)
    want = np.asarray(jl.layernorm(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x)))
    got = tl.layernorm(bridge.tree(p), bridge.tensor(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  want.view(np.uint16))


def test_layernorm_init_matches_reference():
    want = jax.tree.map(lambda q: np.asarray(q.value),
                        jl.layernorm_init(jax.random.PRNGKey(0), 48),
                        is_leaf=lambda q: hasattr(q, "axes"))
    got = tl.layernorm_init(torch.Generator(), 48)
    assert sorted(got) == sorted(want) == ["bias", "scale"]
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
        assert got[k].dtype == torch.float32
