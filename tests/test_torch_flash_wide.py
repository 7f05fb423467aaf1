"""Port parity for flash attention at wide head dims, and the pure choices
the CUDA wrappers make from shapes alone.

The plain forward and backward (``flash_attention_ref``,
``flash_attention_bwd_ref``) against the reference's Pallas
``flash_attention_fwd`` / ``flash_attention_bwd`` in interpret mode at
(D, Dv) = (192, 192), (256, 256) and (192, 128) (the head dims of
gemma3-4b, recurrentgemma-2b and deepseek's MLA): S 256, B 1, 4 q heads
over 2 kv heads, f32, causal and windowed. Inputs are drawn with numpy from
a seed; the backward gets the reference's own forward residuals (o, lse),
so it is compared alone.

Tolerance, as in ``test_torch_flash_bwd.py``: f32,
|got - want| <= 1e-5 * max|want| + 1e-5 * |want| per tensor
(``flash_attention.tolerance``): the reference sums each (256 x 256) tile
product in one XLA dot, the port in one einsum over the full (S, S)
matrix, in another order.

Then, on shapes alone: ``fwd_route`` (which forward kernel a CUDA call
runs, from the dtype and the head dims: "tc", "tf32" or "simt"), and the
backward's row tile (``bwd_rows``) with its shared memory (``bwd_smem``,
the formula of ``flash_attention_bwd.cu``), which fits a block's 232,448
bytes at every head dim pair up to 256.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

S, B, H, K = 256, 1, 4, 2
WIDE = [(192, 192), (256, 256), (192, 128)]
MASKS = [dict(causal=True, window=0), dict(causal=True, window=100)]
CASES = [(d, m) for d in WIDE for m in MASKS]
IDS = [f"{d[0]}-{d[1]}-{'window' if m['window'] else 'causal'}"
       for d, m in CASES]


def _inputs(dims, seed):
    D, Dv = dims
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv),
                           (B, S, H, Dv)))


def _t(x):
    return bridge.tensor(jax.device_get(x))


def _close(got, want, what):
    lim = fa.tolerance(got, want)
    gap = (got.float() - want.float()).abs()
    assert bool((gap <= lim).all()), (
        f"{what}: max |err| {float(gap.max())}, worst against its limit "
        f"{float((gap / lim).max())}")


@pytest.mark.parametrize("dims,kw", CASES, ids=IDS)
def test_plain_forward_matches_reference_pallas_wide(dims, kw):
    q, k, v, _ = _inputs(dims, seed=dims[0] + dims[1])
    o, lse = jfa.flash_attention_fwd(q, k, v, interpret=True, **kw)
    got_o, got_lse = fa.flash_attention_ref(_t(q), _t(k), _t(v),
                                            with_lse=True, **kw)
    assert tuple(got_o.shape) == (B, S, H, dims[1])
    _close(got_o, _t(o), "o")
    _close(got_lse, _t(lse), "lse")


@pytest.mark.parametrize("dims,kw", CASES, ids=IDS)
def test_plain_backward_matches_reference_pallas_wide(dims, kw):
    q, k, v, do = _inputs(dims, seed=dims[0] * dims[1])
    o, lse = jfa.flash_attention_fwd(q, k, v, interpret=True, **kw)
    want = jax.device_get(jfa.flash_attention_bwd(q, k, v, o, lse, do,
                                                  interpret=True, **kw))
    got = fa.flash_attention_bwd_ref(_t(q), _t(k), _t(v), _t(o), _t(lse),
                                     _t(do), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = bridge.tensor(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _close(g, w, name)


BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16


# the f32 cases keep the ids they had when f32 took the SIMT route
@pytest.mark.parametrize("dtype,D,Dv,route", [
    (BF16, 64, 64, "tc"), (BF16, 16, 16, "tc"), (BF16, 128, 128, "tc"),
    (BF16, 192, 192, "tc"), (BF16, 256, 256, "tc"), (BF16, 192, 128, "tc"),
    (BF16, 32, 48, "tc"), (BF16, 8, 8, "simt"), (BF16, 24, 64, "simt"),
    (BF16, 64, 40, "simt"), (BF16, 272, 64, "simt"),
    pytest.param(F32, 64, 64, "tf32", id="dtype11-64-64-simt"),
    pytest.param(F32, 256, 256, "tf32", id="dtype12-256-256-simt"),
    (F16, 64, 64, "simt"),
])
def test_fwd_route_from_dtype_and_head_dims(dtype, D, Dv, route):
    """Three routes: bf16 with both head dims multiples of 16 in [16, 256]
    takes the bf16 tensor-core kernel ("tc"); f32 with both multiples of 8
    in [8, 256] the split-TF32 tensor-core kernel ("tf32"); every other
    dtype or head dim the SIMT kernel ("simt")."""
    assert fa.fwd_route(dtype, D, Dv) == route


@pytest.mark.parametrize("dtype,D", [(BF16, 64), (BF16, 24), (F32, 64)])
def test_forward_cuda_wrapper_refuses_cpu_tensors_on_either_route(dtype, D):
    """A CPU tensor raises at the device check on every route (bf16 at 64:
    the bf16 tensor-core kernel; bf16 at 24: the SIMT kernel; f32 at 64:
    the split-TF32 kernel); no route runs a plain version in the kernel's
    place."""
    x = torch.zeros((1, 64, 2, D), dtype=dtype)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(x, x, x)


def test_bwd_row_tile_fits_shared_memory_at_every_head_dim():
    """64-row tiles up to head dim 128, 32-row tiles above; every (D, Dv)
    in [1, 256]^2 fits a block's shared memory, and 64-row tiles would
    not at (256, 256)."""
    assert fa.bwd_rows(128, 128) == fa.bwd_rows(1, 128) == 64
    assert fa.bwd_rows(129, 16) == fa.bwd_rows(64, 256) == 32
    worst = 0
    for D in range(1, 257):
        for Dv in range(1, 257):
            rows = fa.bwd_rows(D, Dv)
            assert fa.CUDA_BQ % rows == 0
            worst = max(worst, fa.bwd_smem("dq", D, Dv, rows),
                        fa.bwd_smem("dkv", D, Dv, rows))
    assert worst <= fa.SMEM_LIMIT == 232_448
    # the sizes the kernel source states: 64 rows overflow at (256, 256)
    assert fa.bwd_smem("dq", 256, 256, 64) == 280_832
    assert fa.bwd_smem("dkv", 256, 256, 64) == 297_472
    assert fa.bwd_smem("dq", 256, 256, 32) == 136_320
    assert fa.bwd_smem("dkv", 256, 256, 32) == 140_544
