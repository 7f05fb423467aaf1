"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Marked ``cuda``: every test here skips without a
card (decided in the ``card`` fixture, never at import). Run them on a
machine with an H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances as in ``chip_smoke.py``: qdq_cast bitwise (NaN equal to NaN);
the attention kernels within ``flash_attention.tolerance`` (in f32 1e-5
of the tensor's largest magnitude plus 1e-5 relative, in bf16 one bf16 ulp
more). This file imports no JAX.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
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
