"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Marked ``cuda``: every test here skips without a
card (decided in the ``card`` fixture, never at import). Run them on a
machine with an H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances as in ``chip_smoke.py``: qdq_cast bitwise (NaN equal to NaN);
grad_stats' absmax bitwise, its sums within 2^-20 of the sum of the
terms' magnitudes of an f64 sum, non-finite inputs in the same class, two
launches bitwise equal;
the attention kernels, forward and backward (bf16 on the tensor-core
routes; f32 on the split-TF32 forward and backward; the SIMT kernels
through their raw entries), within
``flash_attention.tolerance`` (in f32 1e-5 of the tensor's largest
magnitude plus 1e-5 relative, in bf16 one bf16 ulp more); the
differentiable ``ops.flash_attention`` within 1e-5 of each gradient's
largest magnitude of autograd through the plain forward. This file imports
no JAX.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grad_stats as gs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import qdq_cast as qc  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(a, b) -> bool:
    a, b = a.float(), b.float()
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def _close(got, want):
    d = (got.float() - want.float()).abs()
    return bool(torch.isfinite(got).all()) and bool(
        (d <= fa.tolerance(got, want)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ladder", ["tpu", "gpu"])
def test_qdq_cast_kernel_bitwise(card, ladder, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    x = (torch.randn((300, 77), generator=g, device=card) * 3).to(dtype)
    for amax in (None, torch.tensor(1.7, device=card)):
        for code in (0, 1, 2):
            got = ops.qdq_cast(x, code, ladder, amax)
            assert _same(got, qc.qdq_cast_ref(x, code, ladder, amax))


QDQ_SIZES = (0, 1, 7, 8, 9, 15, 16, 17, 1_048_579)


def _qdq_input(card, n, off, dtype, seed):
    """``n`` elements at ``off`` elements into a larger buffer (so the
    kernel meets every alignment); the large size holds NaN, +-inf and
    fp16-range edges."""
    g = torch.Generator(device=card).manual_seed(seed)
    buf = (torch.randn((n + 8,), generator=g, device=card) * 3).to(dtype)
    x = buf[off:off + n]
    edges = torch.tensor([float("nan"), float("inf"), -float("inf"), 7e4,
                          -1e-30, 448.0, 12.0], device=card).to(dtype)
    if n > 64:
        x[n // 2:n // 2 + len(edges)] = edges
    return x


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qdq_cast_kernel_offsets_sizes_and_output_type(card, dtype,
                                                       out_dtype):
    """Both forms against the plain version, bitwise (NaN equal to NaN),
    at offsets 0-7 elements into a buffer and sizes around the 8-element
    unit and the 16-byte boundary, with the output written as f32 or
    bf16; a NaN in x makes the two-pass absmax NaN, whose scale is 1."""
    for off in range(8):
        for n in QDQ_SIZES:
            x = _qdq_input(card, n, off, dtype, seed=n + off)
            for ladder in ("tpu", "gpu"):
                for amax in (None, torch.tensor(9.5, device=card),
                             torch.tensor(0.5, device=card)):
                    for code in (0, 1, 2):
                        got = ops.qdq_cast(x, code, ladder, amax,
                                           out_dtype=out_dtype)
                        want = qc.qdq_cast_ref(x, code, ladder, amax,
                                               out_dtype=out_dtype)
                        assert got.dtype == out_dtype
                        assert got.shape == x.shape
                        assert _same(got, want), (off, n, ladder, amax,
                                                  code)


def test_qdq_cast_kernel_repeats_bitwise_and_counts_by_form(card):
    """Ten calls of each form give the same bits; each call counts one
    launch in ``qdq_cast`` and one under its form, an empty tensor none."""
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn((1_048_579,), generator=g, device=card)
    amax = x.abs().amax()
    for form, args in (("two_pass", (0, "tpu", None)),
                       ("one_pass", (0, "tpu", amax)),
                       ("one_pass", (0, "gpu", None)),
                       ("one_pass", (1, "tpu", None))):
        before = dict(ops.LAUNCHES)
        first = ops.qdq_cast(x, *args, out_dtype=torch.bfloat16)
        for _ in range(9):
            again = ops.qdq_cast(x, *args, out_dtype=torch.bfloat16)
            assert torch.equal(again.view(torch.int16),
                               first.view(torch.int16))
        grew = {k: ops.LAUNCHES[k] - before[k] for k in before
                if ops.LAUNCHES[k] != before[k]}
        assert grew == {"qdq_cast": 10, f"qdq_cast_{form}": 10}, args
    before = dict(ops.LAUNCHES)
    assert ops.qdq_cast(x[:0], 0).shape == (0,)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("n", [576, 1_048_579])
def test_qdq_cast_kernel_is_one_device_operation(card, n):
    """Each form is one operation on the card a call: no memset, no second
    kernel (``torch.profiler``; inputs and outputs made outside)."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=card).manual_seed(4)
    x = torch.randn((n,), generator=g, device=card)
    amax = x.abs().amax()
    for args in ((0, "tpu", None), (0, "tpu", amax)):
        ops.qdq_cast(x, *args)
        torch.cuda.synchronize()
        for _ in range(3):      # a trace that came back empty is taken again
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                ops.qdq_cast(x, *args)
                torch.cuda.synchronize()
            dev = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            if dev:
                break
        assert len(dev) == 1 and "qdq_kernel" in dev[0], dev


@pytest.mark.parametrize("shape", [(64,), (513, 129), (1024, 512),
                                   (7, 3, 5), (8,), (0,), (1_000_000,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_grad_stats_kernel_matches_plain(card, shape, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=card) * 2).to(dtype)
    got = ops.grad_stats(x)
    again = ops.grad_stats(x)
    want = gs.grad_stats_ref(x)
    assert all(t.dim() == 0 and t.dtype == torch.float32 for t in got)
    assert all(_same(a, b) for a, b in zip(got, again))
    assert _same(got[2], want[2])
    v = x.double().reshape(-1)
    for k, (truth, mass) in enumerate(((v.sum(), v.abs().sum()),
                                       ((v * v).sum(), (v * v).sum()))):
        assert float((got[k].double() - truth).abs()) <= 2.0 ** -20 * float(
            mass)


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_grad_stats_kernel_non_finite_and_strided(card, bad):
    x = torch.randn((300, 77), device=card)
    x[17, 3] = bad
    cls = lambda t: ("nan" if torch.isnan(t) else str(float(t))  # noqa
                     if torch.isinf(t) else "finite")
    got, want = ops.grad_stats(x.T), gs.grad_stats_ref(x)
    assert [cls(t) for t in got] == [cls(t) for t in want]
    assert _same(got[2], want[2])
    off = ops.grad_stats(x.reshape(-1)[1:])     # a 4-byte-aligned start
    assert _same(off[2], gs.grad_stats_ref(x.reshape(-1)[1:])[2])


@pytest.mark.parametrize("variant", ["causal", "noncausal", "window",
                                     "segments"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_kernel_matches_plain(card, variant, dtype):
    g = torch.Generator(device=card).manual_seed(1)
    B, S, H, K, D = 2, 256, 9, 3, 64
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=card
                           ).to(dtype) for h in (H, K, K))
    seg = None
    if variant == "segments":
        seg = (torch.arange(S, device=card) // 77).to(torch.int32)
        seg = seg[None].expand(B, S).contiguous()
    kw = dict(causal=variant != "noncausal",
              window=100 if variant == "window" else 0)
    o, lse = fa.flash_attention_cuda(q, k, v, seg, with_lse=True, **kw)
    o_r, lse_r = fa.flash_attention_ref(q, k, v, seg, with_lse=True, **kw)
    assert _close(o, o_r)
    assert float((lse - lse_r).abs().max()) <= 1e-5 * (
        1 + float(lse_r.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(card, dtype):
    g = torch.Generator(device=card).manual_seed(2)
    B, L, H, K, D = 5, 512, 9, 3, 64
    q = torch.randn((B, 1, H, D), generator=g, device=card).to(dtype)
    k, v = (torch.randn((B, L, K, D), generator=g, device=card).to(dtype)
            for _ in range(2))
    lens = torch.tensor([0, 1, L, 300, 64], dtype=torch.int32, device=card)
    got = fa.flash_decode_cuda(q, k, v, lens)
    assert _close(got, fa.flash_decode_ref(q, k, v, lens))
    assert bool((got[0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_split_edges_and_repeat(card, dtype):
    """The split-key decode at lengths on the edges of the cluster's split
    (below N, N, N + 1, c N +- 1, L - 1, L; and -3, L + 5, clamped) and
    at B 1, against the plain version; each call repeats bitwise."""
    g = torch.Generator(device=card).manual_seed(11)
    N, L, H, K, D = fa.DECODE_CLUSTER, 2048, 9, 3, 64
    edges = [0, 1, N - 1, N, N + 1, 17 * N - 1, 17 * N + 1, 64 * N - 1,
             64 * N + 1, L - 1, L, -3, L + 5]
    for lens in (edges, [1071]):
        B = len(lens)
        q = torch.randn((B, 1, H, D), generator=g, device=card).to(dtype)
        k, v = (torch.randn((B, L, K, D), generator=g, device=card
                            ).to(dtype) for _ in range(2))
        lens = torch.tensor(lens, dtype=torch.int32, device=card)
        got = fa.flash_decode_cuda(q, k, v, lens)
        assert _close(got, fa.flash_decode_ref(q, k, v, lens))
        assert _same(got, fa.flash_decode_cuda(q, k, v, lens))
        for i in (lens <= 0).nonzero().flatten().tolist():
            assert bool((got[i] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dv", [40, 256])
def test_flash_bwd_delta_vector_tail_and_repeat(card, Dv, dtype):
    """delta at Dv 40 (five bf16 chunks: a lane takes a second one) and 256,
    and at a sequence length that leaves a partial last block, against the
    plain version; each call repeats bitwise."""
    g = torch.Generator(device=card).manual_seed(12)
    for S in (1024, 1000):
        o, do = (torch.randn((2, S, 9, Dv), generator=g, device=card
                             ).to(dtype) for _ in range(2))
        got = fa.flash_bwd_delta_cuda(o, do)
        assert _close(got, fa.flash_bwd_delta_ref(o, do))
        assert _same(got, fa.flash_bwd_delta_cuda(o, do))


def _seg(card, B, S):
    seg = (torch.arange(S, device=card) // 77).to(torch.int32)
    return seg[None].expand(B, S).contiguous()


@pytest.mark.parametrize("variant", ["causal", "noncausal", "window",
                                     "segments", "dv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels_match_plain(card, variant, dtype):
    """delta, dQ and dK/dV against their plain versions on the same
    residuals (the plain forward's o and lse)."""
    g = torch.Generator(device=card).manual_seed(3)
    B, S, H, K, D = 2, 256, 9, 3, 64
    Dv = 32 if variant == "dv" else D
    q, k, v, do = (torch.randn(s, generator=g, device=card).to(dtype)
                   for s in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv),
                             (B, S, H, Dv)))
    seg = _seg(card, B, S) if variant == "segments" else None
    kw = dict(causal=variant != "noncausal",
              window=100 if variant == "window" else 0)
    o, lse = fa.flash_attention_ref(q, k, v, seg, with_lse=True, **kw)
    delta = fa.flash_bwd_delta_ref(o, do)
    assert _close(fa.flash_bwd_delta_cuda(o, do), delta)
    assert _close(fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, seg, **kw),
                  fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, seg, **kw))
    got = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, seg, **kw)
    want = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, seg, **kw)
    assert all(_close(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("variant", ["causal", "segments"])
def test_flash_function_gradient_matches_plain_autograd(card, variant):
    """``ops.flash_attention`` through the kernels (forward with LSE,
    delta, dQ, dK/dV) against autograd through the plain forward, f32:
    within 1e-5 of each gradient's largest magnitude."""
    g = torch.Generator(device=card).manual_seed(4)
    B, S, H, K, D = 2, 512, 9, 3, 64
    q, k, v, do = (torch.randn(s, generator=g, device=card)
                   for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D),
                             (B, S, H, D)))
    seg = _seg(card, B, S) if variant == "segments" else None
    ins = [x.requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*ins, segments=seg), ins,
                              do)
    want = torch.autograd.grad(fa.flash_attention_ref(*ins, seg), ins, do)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


WIDE = [(128, 128), (192, 192), (256, 256), (192, 128)]


# the f32 case keeps the id it had when f32 took the SIMT route
@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "tc"),
    pytest.param(torch.float32, "tf32", id="dtype1-simt")])
@pytest.mark.parametrize("dims", WIDE, ids=lambda d: f"{d[0]}-{d[1]}")
def test_flash_forward_wide_heads_both_routes(card, dims, dtype, route):
    """Both tensor-core forward kernels at head dims 128-256 (bf16 takes
    the bf16 kernel, f32 the split-TF32 kernel; GQA rep 2; causal and
    windowed) against the plain version."""
    g = torch.Generator(device=card).manual_seed(5)
    (D, Dv), (B, S, H, K) = dims, (2, 256, 4, 2)
    assert fa.fwd_route(dtype, D, Dv) == route
    q, k, v = (torch.randn(s, generator=g, device=card).to(dtype)
               for s in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv)))
    for window in (0, 100):
        o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True,
                                         window=window)
        o_r, lse_r = fa.flash_attention_ref(q, k, v, with_lse=True,
                                            window=window)
        assert _close(o, o_r)
        assert float((lse - lse_r).abs().max()) <= 1e-5 * (
            1 + float(lse_r.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", WIDE[1:], ids=lambda d: f"{d[0]}-{d[1]}")
def test_flash_backward_kernels_wide_heads(card, dims, dtype):
    """dQ and dK/dV at head dims above 128 (32-row tiles) against their
    plain versions on the plain forward's residuals."""
    g = torch.Generator(device=card).manual_seed(6)
    (D, Dv), (B, S, H, K) = dims, (2, 256, 4, 2)
    q, k, v, do = (torch.randn(s, generator=g, device=card).to(dtype)
                   for s in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv),
                             (B, S, H, Dv)))
    for window in (0, 100):
        kw = dict(causal=True, window=window)
        o, lse = fa.flash_attention_ref(q, k, v, with_lse=True, **kw)
        delta = fa.flash_bwd_delta_ref(o, do)
        assert _close(fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw),
                      fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw))
        got = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
        want = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
        assert all(_close(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("hk", [(4, 2), (9, 3)], ids=["rep2", "rep3"])
@pytest.mark.parametrize("variant", ["causal", "noncausal", "window",
                                     "segments"])
def test_flash_backward_tc_kernels_match_plain(card, variant, hk):
    """The tensor-core dQ and dK/dV (bf16, ``bwd_route`` "tc") against
    their plain versions on the plain forward's residuals, over the four
    masks and GQA rep 2 and 3, head dim 64."""
    g = torch.Generator(device=card).manual_seed(8)
    (H, K), (B, S, D) = hk, (2, 256, 64)
    assert fa.bwd_route(torch.bfloat16, D, D) == "tc"
    q, k, v, do = (torch.randn(s, generator=g, device=card).to(torch.bfloat16)
                   for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D),
                             (B, S, H, D)))
    seg = _seg(card, B, S) if variant == "segments" else None
    kw = dict(causal=variant != "noncausal",
              window=100 if variant == "window" else 0)
    o, lse = fa.flash_attention_ref(q, k, v, seg, with_lse=True, **kw)
    delta = fa.flash_bwd_delta_ref(o, do)
    assert _close(fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, seg, **kw),
                  fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, seg, **kw))
    got = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, seg, **kw)
    want = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, seg, **kw)
    assert all(_close(a, b) for a, b in zip(got, want))


def test_flash_backward_counts_launches_by_route(card):
    """``ops.flash_bwd_dq`` / ``flash_bwd_dkv`` count each launch in their
    totals and under their route: bf16 at head dim 64 the tensor-core
    kernels, f32 the split-TF32 kernels."""
    g = torch.Generator(device=card).manual_seed(9)
    B, S, H, K, D = 1, 256, 2, 1, 64
    for dtype, route in ((torch.bfloat16, "tc"), (torch.float32, "tf32")):
        q, k, v, do = (torch.randn(s, generator=g, device=card).to(dtype)
                       for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D),
                                 (B, S, H, D)))
        o, lse = fa.flash_attention_ref(q, k, v, with_lse=True)
        delta = fa.flash_bwd_delta_ref(o, do)
        before = dict(ops.LAUNCHES)
        ops.flash_bwd_dq(q, k, v, do, lse, delta)
        ops.flash_bwd_dkv(q, k, v, do, lse, delta)
        grew = {k_: ops.LAUNCHES[k_] - before[k_] for k_ in before
                if ops.LAUNCHES[k_] != before[k_]}
        assert grew == {"flash_attention_bwd_dq": 1,
                        f"flash_attention_bwd_dq_{route}": 1,
                        "flash_attention_bwd_dkv": 1,
                        f"flash_attention_bwd_dkv_{route}": 1}


def test_flash_forward_counts_launches_by_route(card):
    """``ops.flash_attention`` counts each forward launch in its total and
    under its route: bf16 at head dim 64 the tensor-core kernel, f32 the
    split-TF32 kernel."""
    g = torch.Generator(device=card).manual_seed(7)
    x = torch.randn((1, 256, 2, 64), generator=g, device=card)
    for dtype, route in ((torch.bfloat16, "tc"), (torch.float32, "tf32")):
        before = dict(ops.LAUNCHES)
        ops.flash_attention(x.to(dtype), x.to(dtype), x.to(dtype))
        grew = {k: ops.LAUNCHES[k] - before[k] for k in before
                if ops.LAUNCHES[k] != before[k]}
        assert grew == {"flash_attention": 1,
                        f"flash_attention_{route}": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", [(64, 64), (24, 64), (192, 128)],
                         ids=lambda d: f"{d[0]}-{d[1]}")
def test_flash_backward_simt_kernels_through_their_raw_entry(card, dims,
                                                             dtype):
    """The SIMT dQ and dK/dV through their raw entry, whatever
    ``bwd_route`` picks (f32 takes the split-TF32 kernels): against their
    plain versions, causal and windowed, GQA rep 3."""
    g = torch.Generator(device=card).manual_seed(13)
    (D, Dv), (B, S, H, K) = dims, (2, 256, 6, 2)
    q, k, v, do = (torch.randn(s, generator=g, device=card).to(dtype)
                   for s in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv),
                             (B, S, H, Dv)))
    lib, stream = fa._bwd_lib(), torch.cuda.current_stream().cuda_stream
    for window in (0, 100):
        kw = dict(causal=True, window=window)
        o, lse = fa.flash_attention_ref(q, k, v, with_lse=True, **kw)
        delta = fa.flash_bwd_delta_ref(o, do)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        ins = tuple(x.data_ptr() for x in (q, k, v, do, lse, delta)) + (
            None,)
        dims_ = (fa._DTYPE_CODE[dtype], B, S, H, K, D, Dv, 1, window,
                 D ** -0.5, fa.bwd_rows(D, Dv))
        assert lib.tri_flash_bwd_dq(*ins, dq.data_ptr(), *dims_,
                                    stream) == 0
        assert lib.tri_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                                     *dims_, stream) == 0
        torch.cuda.synchronize()
        assert _close(dq, fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw))
        want = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
        assert _close(dk, want[0]) and _close(dv, want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_simt_kernel_through_its_raw_entry(card, dtype):
    """The SIMT forward through its raw entry (``tri_flash_fwd``), whatever
    ``fwd_route`` picks (f32 and bf16 at head dim 64 take the tensor-core
    routes): o and the LSE against the plain version, causal and windowed,
    GQA rep 3."""
    g = torch.Generator(device=card).manual_seed(14)
    B, S, H, K, D = 2, 256, 6, 2, 64
    q, k, v = (torch.randn(s, generator=g, device=card).to(dtype)
               for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
    lib, stream = fa._lib(), torch.cuda.current_stream().cuda_stream
    for window in (0, 100):
        o = torch.empty_like(q)
        lse = torch.empty((B, H, S), device=card)
        assert lib.tri_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 None, o.data_ptr(), lse.data_ptr(),
                                 fa._DTYPE_CODE[dtype], B, S, H, K, D, D, 1,
                                 window, D ** -0.5, stream) == 0
        torch.cuda.synchronize()
        o_r, lse_r = fa.flash_attention_ref(q, k, v, with_lse=True,
                                            window=window)
        assert _close(o, o_r)
        assert float((lse - lse_r).abs().max()) <= 1e-5 * (
            1 + float(lse_r.abs().max()))
