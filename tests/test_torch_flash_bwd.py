"""Port parity for the flash-attention backward: the plain backward
(``flash_attention_bwd_ref``: delta, dQ, dK/dV from the saved LSE) against
the reference's Pallas backward in interpret mode, the differentiable
``ops.flash_attention`` (a ``torch.autograd.Function`` over the forward
and backward kernels' plain versions on the CPU) against plain autograd,
and ``flash_fallback``.

Inputs are drawn with numpy from a seed; both sides get the reference's
own forward residuals (o, lse), so the backward is compared alone.

Tolerances:
  * f32: |got - want| <= 1e-5 * max|want| + 1e-5 * |want| per tensor. The
    reference sums each (256 x 256) tile product in one XLA dot, the port
    in one einsum over the full (S, S) matrix, in another order; the gaps
    measured are below 8e-7 of the largest magnitude;
  * bf16 (the working type of the main path): the same plus one bf16 ulp
    of the larger of the two values (``flash_attention.tolerance``): both
    sides compute in f32 and round once to bf16, so values whose f32 sums
    differ in the last bits may round to neighbouring bf16 values;
  * the autograd Function against autograd through ``flash_attention_ref``:
    within 2e-6 of each gradient's largest magnitude (measured below
    4e-7): the Function rebuilds p from the LSE and takes
    ds = p (dp - delta), autograd differentiates the softmax.
"""
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.nn.attention import _chunked_attention  # noqa: E402

S, B, K, D = 256, 2, 2, 16


@pytest.fixture(autouse=True)
def _process_state():
    """Leave nothing process-wide changed for the test files that share
    this worker: the fallback warnings and the launch counts; and no test
    may leave ``flash_fallback`` on."""
    warned, launches = set(ops.WARNED_FALLBACKS), dict(ops.LAUNCHES)
    yield
    ops.WARNED_FALLBACKS.clear()
    ops.WARNED_FALLBACKS.update(warned)
    ops.LAUNCHES.update(launches)
    assert not ops.fallback_forced()

# (causal, window, segments, rep, Dv, dtype): a covering design of the
# masks x GQA rep {1, 2} x one Dv != D case, in f32 and bf16
CASES = [
    (True, 0, False, 1, 16, "float32"),
    (False, 0, False, 2, 16, "float32"),
    (True, 100, False, 2, 16, "float32"),
    (True, 0, True, 2, 16, "float32"),
    (False, 0, True, 1, 32, "float32"),
    (True, 0, False, 2, 16, "bfloat16"),
    (True, 64, True, 1, 16, "bfloat16"),
    (True, 0, False, 2, 32, "bfloat16"),
]


def _segments(rng):
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        for c in rng.choice(np.arange(1, S), 3, replace=False):
            seg[b, c:] += 1
    return seg


def _inputs(case, seed=0):
    causal, window, segs, rep, Dv, dtype = case
    rng = np.random.default_rng(seed)
    H = K * rep
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    q, k, v, do = (rng.standard_normal(s).astype(np.float32).astype(dt)
                   for s in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv),
                             (B, S, H, Dv)))
    seg = _segments(rng) if segs else None
    return q, k, v, do, seg, dict(causal=causal, window=window)


def _close(got, want, what):
    lim = fa.tolerance(got, want)
    gap = (got.float() - want.float()).abs()
    assert bool((gap <= lim).all()), (
        f"{what}: max |err| {float(gap.max())}, worst against its limit "
        f"{float((gap / lim).max())}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_backward_matches_reference_pallas(case):
    q, k, v, do, seg, kw = _inputs(case)
    jseg = None if seg is None else jnp.asarray(seg)
    o, lse = jfa.flash_attention_fwd(q, k, v, jseg, interpret=True, **kw)
    want = jax.device_get(jfa.flash_attention_bwd(
        q, k, v, o, lse, do, jseg, interpret=True, **kw))
    t = lambda x: bridge.tensor(jax.device_get(x))   # noqa: E731
    got = fa.flash_attention_bwd_ref(
        t(q), t(k), t(v), t(o), t(lse), t(do),
        None if seg is None else t(seg), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = bridge.tensor(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _close(g, w, name)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[4]],
                         ids=["causal", "window", "segments-dv"])
def test_autograd_function_matches_plain_autograd(case):
    q, k, v, do, seg, kw = _inputs(case, seed=1)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    seg_t = None if seg is None else torch.from_numpy(seg)
    dot = torch.from_numpy(do)
    o = ops.flash_attention(qt, kt, vt, segments=seg_t, **kw)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(o, (qt, kt, vt), dot)
    o_ref = fa.flash_attention_ref(qt, kt, vt, seg_t, **kw)
    want = torch.autograd.grad(o_ref, (qt, kt, vt), dot)
    assert torch.equal(o.detach(), o_ref.detach())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        gap = float((g - w).abs().max())
        assert gap <= 2e-6 * float(w.abs().max()), (name, gap)


def test_no_grad_forward_keeps_the_plain_kernel_path():
    """Without grad the op is the forward kernel alone (no LSE, no
    Function), as on the serving path."""
    q, k, v, _, _, kw = _inputs(CASES[0])
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    with torch.no_grad():
        o = ops.flash_attention(qt, kt, vt, **kw)
    assert o.grad_fn is None
    torch.testing.assert_close(
        o, fa.flash_attention_ref(qt.detach(), kt.detach(), vt.detach(),
                                  **kw), rtol=0, atol=0)


def test_flash_fallback_pins_the_chunked_path_without_warning():
    q, k, v, do, _, kw = _inputs(CASES[2], seed=2)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    assert not ops.fallback_forced()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with ops.flash_fallback():
            assert ops.fallback_forced()
            o = ops.flash_attention(qt, kt, vt, **kw)
            with ops.flash_fallback(False):     # nests and restores
                assert not ops.fallback_forced()
            assert ops.fallback_forced()
    assert not ops.fallback_forced()
    assert type(o.grad_fn).__name__ != "_FlashAttentionBackward"
    want = _chunked_attention(qt, kt, vt, pos, pos, True, kw["window"],
                              D ** -0.5, fa.BQ, fa.BK)
    torch.testing.assert_close(o, want, rtol=0, atol=0)
    with pytest.raises(RuntimeError):
        with ops.flash_fallback():
            raise RuntimeError("boom")
    assert not ops.fallback_forced()          # restored on the way out


def test_backward_kernels_refuse_cpu_tensors_and_wide_heads():
    """The CUDA wrappers take CUDA tensors only; nothing falls back. Head
    dims up to 256 reach the device check (the dQ and dK/dV kernels take
    them: their row tile drops to 32 above head dim 128); above 256 the
    forward and every backward wrapper refuse the head dim before they
    look at the device."""
    q, k, v, do, _, _ = _inputs(CASES[0])
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    lse = torch.zeros((B, K, S))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_bwd_delta_cuda(qt, dot)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_bwd_dq_cuda(qt, kt, vt, dot, lse, lse)
    assert fa.BWD_MAX_HEAD_DIM == fa.MAX_HEAD_DIM == 256
    wide = torch.zeros((B, S, K, 192))
    for fn in (fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(wide, wide, wide, wide, lse, lse)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_bwd_delta_cuda(wide, wide)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(wide, wide, wide)
    over = torch.zeros((B, S, K, 272))
    with pytest.raises(ValueError, match="above 256"):
        fa.flash_attention_cuda(over, over, over)
    with pytest.raises(ValueError, match="above 256"):
        fa.flash_bwd_delta_cuda(over, over)
    for fn in (fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="above 256"):
            fn(over, over, over, over, lse, lse)
