"""The flash backward's tensor-core route (``csrc/flash_bwd_sm90.cu``), on
the CPU: the choices its wrappers make from shapes alone, and its numerics.

``bwd_route`` picks the dQ and dK/dV kernels from the dtype and the head
dims alone: bf16 with D and Dv multiples of 16 in [16, 256] takes the
tensor-core kernels (``fwd_route``'s "tc"), f32 with D and Dv multiples of
8 in [8, 256] the split-TF32 kernels ("tf32", whose forward is the SIMT
kernel), everything else the SIMT kernels. Every route's wrapper refuses a
CPU tensor, and a head dim above 256 before it looks at the device.
``bwd_tc_smem`` mirrors the kernels' shared memory and fits a block's
232,448 bytes at every head dim they take.

The numerics: a plain-torch emulation of what the kernels compute, at a
small bf16 shape (B 1, S 256, 4 q heads over 2 kv heads, D = Dv = 64 and
256, causal and windowed), against ``flash_bwd_dq_ref`` /
``flash_bwd_dkv_ref`` within the unchanged ``flash_attention.tolerance``.
S = Q K^T and dP = dO V^T take bf16 inputs and f32 sums, as on the tensor
cores; P = exp2(S scale log2 e - lse log2 e), 0 at masked pairs; dS = P
(dP - delta). P and dS enter the products dQ = dS K, dK = dS^T Q and
dV = P^T dO rounded as the kernels round their register operands: hi =
bf16(x) and lo = bf16(x - hi), two products each. That split holds the
tolerance, at the bf16 rounding of the outputs; one bf16 operand breaks it
many times over where the sums cancel, which is why the kernels split.

Last, the bound ``chip_smoke.py`` holds the bf16 autograd op to on the card
(2^-7 of each gradient's largest magnitude against f32 autograd) is held
by the same bf16 chain through the plain versions here.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16
SOURCE = (Path(fa.__file__).resolve().parent / "csrc" / "flash_bwd_sm90.cu")
LOG2E = 1.4426950408889634


# the f32 cases keep the ids they had when f32 took the SIMT route
@pytest.mark.parametrize("dtype,D,Dv,route", [
    (BF16, 64, 64, "tc"), (BF16, 16, 16, "tc"), (BF16, 128, 128, "tc"),
    (BF16, 192, 192, "tc"), (BF16, 256, 256, "tc"), (BF16, 192, 128, "tc"),
    (BF16, 64, 32, "tc"), (BF16, 32, 64, "tc"), (BF16, 8, 8, "simt"),
    (BF16, 24, 64, "simt"), (BF16, 64, 40, "simt"), (BF16, 272, 64, "simt"),
    pytest.param(F32, 64, 64, "tf32", id="dtype12-64-64-simt"),
    pytest.param(F32, 256, 256, "tf32", id="dtype13-256-256-simt"),
    (F16, 64, 64, "simt"),
])
def test_bwd_route_from_dtype_and_head_dims(dtype, D, Dv, route):
    """bf16 with both head dims multiples of 16 in [16, 256] takes the
    tensor-core dQ and dK/dV, by the forward's rule; f32 with both
    multiples of 8 in [8, 256] the split-TF32 kernels, while its forward
    stays on the SIMT kernel; every other dtype or head dim the SIMT
    kernels, as the forward."""
    assert fa.bwd_route(dtype, D, Dv) == route
    fwd = fa.fwd_route(dtype, D, Dv)
    if dtype == BF16:
        assert route == fwd
    else:
        assert fwd == "simt" and route == ("tf32" if dtype == F32 else
                                           "simt")


def _bwd_args(dtype, D, Dv, B=1, S=64, H=2, K=1):
    q, do = (torch.zeros((B, S, H, d), dtype=dtype) for d in (D, Dv))
    k, v = (torch.zeros((B, S, K, d), dtype=dtype) for d in (D, Dv))
    lse = torch.zeros((B, H, S))
    return q, k, v, do, lse, lse


# the f32 cases keep the ids they had when f32 took the SIMT route
@pytest.mark.parametrize("dtype,D,Dv,route", [
    (BF16, 64, 64, "tc"), (BF16, 256, 128, "tc"), (BF16, 24, 24, "simt"),
    pytest.param(F32, 64, 64, "tf32", id="dtype3-64-64-simt"),
    pytest.param(F32, 256, 256, "tf32", id="dtype4-256-256-simt"),
])
def test_backward_wrappers_refuse_cpu_tensors_on_either_route(dtype, D, Dv,
                                                              route):
    """dQ and dK/dV raise at the device check on every route (tensor
    cores, split TF32, SIMT): no route runs a plain version in the
    kernel's place."""
    assert fa.bwd_route(dtype, D, Dv) == route
    args = _bwd_args(dtype, D, Dv)
    for fn in (fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(*args)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_backward_wrappers_refuse_head_dims_above_256(dtype):
    """A head dim of 272 raises "above 256" before the device check, in
    bf16 (whose route would otherwise be decided) and in f32."""
    for D, Dv in ((272, 64), (64, 272)):
        args = _bwd_args(dtype, D, Dv)
        for fn in (fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda):
            with pytest.raises(ValueError, match="above 256"):
                fn(*args)


TC_DIMS = range(16, 257, 16)


def test_bwd_tc_smem_fits_at_every_tc_head_dim():
    """Every (D, Dv) the tensor-core kernels take fits a block's shared
    memory, the largest at (256, 256)."""
    worst = max(fa.bwd_tc_smem(kern, D, Dv) for kern in ("dq", "dkv")
                for D in TC_DIMS for Dv in TC_DIMS)
    assert worst == fa.bwd_tc_smem("dkv", 256, 256) <= fa.SMEM_LIMIT
    assert all(fa.bwd_route(BF16, D, Dv) == "tc"
               for D in TC_DIMS for Dv in TC_DIMS)


@pytest.mark.parametrize("D,dq_bytes,dkv_bytes", [
    (64, 50_216, 51_240), (128, 99_368, 100_392), (256, 197_672, 198_696)])
def test_bwd_tc_smem_equals_the_kernel_source(D, dq_bytes, dkv_bytes):
    """The mirror gives the sizes the kernel source states (its header
    comment) at D = Dv = 64, 128 and 256."""
    assert fa.bwd_tc_smem("dq", D, D) == dq_bytes
    assert fa.bwd_tc_smem("dkv", D, D) == dkv_bytes
    text = SOURCE.read_text()
    stated = text[text.index("// Shared memory"):text.index("// Precision")]
    for n in (dq_bytes, dkv_bytes):
        assert re.search(rf"\b{n:,}\b", stated), f"{n:,} not in the source"


# ------------------------------------------------------------ numerics ----
def _split(x, hilo):
    hi = x.to(BF16).float()
    return [hi, (x - hi).to(BF16).float()] if hilo else [hi]


def tc_emulation(q, k, v, do, lse, delta, *, causal, window, hilo=True):
    """What the tensor-core dQ and dK/dV compute, in plain torch: f32 sums
    of bf16 products for S and dP, P in log2 units, and P and dS as bf16
    hi + lo (or, with ``hilo=False``, one bf16) register operands ->
    (dq, dk, dv) in bf16."""
    B, S, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    scale = D ** -0.5
    idx = torch.arange(S)
    d = idx[:, None] - idx[None, :]
    kept = torch.ones((S, S), dtype=torch.bool)
    if causal:
        kept &= d >= 0
    if window:
        kept &= d < window
    dq = torch.zeros((B, S, H, D))
    dk = torch.zeros((B, S, K, D))
    dv = torch.zeros((B, S, K, Dv))
    for b in range(B):
        for h in range(H):
            g = h // (H // K)
            qf, dof = q[b, :, h].float(), do[b, :, h].float()
            kf, vf = k[b, :, g].float(), v[b, :, g].float()
            x = (qf @ kf.T) * (scale * LOG2E) - lse[b, h, :, None] * LOG2E
            p = torch.where(kept, torch.exp2(x), 0.0)
            ds = p * (dof @ vf.T - delta[b, h, :, None])
            dq[b, :, h] = sum(a @ kf for a in _split(ds, hilo)) * scale
            dk[b, :, g] += sum(a.T @ qf for a in _split(ds, hilo)) * scale
            dv[b, :, g] += sum(a.T @ dof for a in _split(p, hilo))
    return dq.to(BF16), dk.to(BF16), dv.to(BF16)


def _worst(got, want) -> float:
    """Largest |got - want| over its ``tolerance`` limit (<= 1 passes)."""
    gap = (got.float() - want.float()).abs()
    return float((gap / fa.tolerance(got, want)).max())


NUM_CASES = [(D, w) for D in (64, 256) for w in (0, 100)]
NUM_IDS = [f"D{D}-{'window' if w else 'causal'}" for D, w in NUM_CASES]


def _numeric_case(D, window, hilo):
    B, S, H, K = 1, 256, 4, 2
    rng = np.random.default_rng(D + window)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                    ).to(BF16)
                   for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D),
                             (B, S, H, D)))
    kw = dict(causal=True, window=window)
    o, lse = fa.flash_attention_ref(q, k, v, with_lse=True, **kw)
    delta = fa.flash_bwd_delta_ref(o, do)
    got = tc_emulation(q, k, v, do, lse, delta, hilo=hilo, **kw)
    want = (fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw),
            *fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw))
    return [_worst(g, w) for g, w in zip(got, want)]


@pytest.mark.parametrize("D,window", NUM_CASES, ids=NUM_IDS)
def test_tc_numerics_with_hilo_split_hold_tolerance(D, window):
    """P and dS as bf16 hi + lo operands: dq, dk and dv within
    ``flash_attention.tolerance`` of the plain versions."""
    worst = _numeric_case(D, window, hilo=True)
    assert max(worst) <= 1.0, f"worst |err| / limit (dq, dk, dv) {worst}"


@pytest.mark.parametrize("D,window", NUM_CASES, ids=NUM_IDS)
def test_tc_numerics_single_bf16_operand_breaks_tolerance(D, window):
    """One bf16 P and dS (2^-9 a term) would break the tolerance several
    times over in each of dq, dk and dv: the reason for the split."""
    worst = _numeric_case(D, window, hilo=False)
    assert min(worst) > 4.0, f"worst |err| / limit (dq, dk, dv) {worst}"


FN_CASES = [(256, "causal", 64), (256, "segments", 64), (512, "window", 64),
            (1024, "causal", 64), (256, "causal", 256)]


@pytest.mark.parametrize("S,variant,D", FN_CASES,
                         ids=[f"{s}-{v}-D{d}" for s, v, d in FN_CASES])
def test_bf16_function_plain_chain_within_the_card_bound(S, variant, D):
    """The bound ``chip_smoke.py`` holds the bf16 autograd op to on the card
    (its gradients within 2^-7 of each gradient's largest magnitude of f32
    autograd through the plain forward) holds for the same bf16 chain
    through the plain versions here, at the card check's shapes: the
    gradients' bf16 rounding and delta from the bf16 o, before any kernel
    adds its own ulp."""
    from repro_torch.kernels import ops
    B, H, K = 2, 9, 3
    rng = np.random.default_rng(S + D)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                    ).to(BF16)
                   for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D),
                             (B, S, H, D)))
    seg = None
    if variant == "segments":
        seg = torch.from_numpy(np.repeat(np.arange(4), S // 4)[None]
                               .repeat(B, 0).astype(np.int32))
    kw = dict(causal=True, window=100 if variant == "window" else 0)
    ins = [x.requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*ins, segments=seg, **kw),
                              ins, do)
    ins32 = [x.detach().float().requires_grad_(True) for x in ins]
    want = torch.autograd.grad(fa.flash_attention_ref(*ins32, seg, **kw),
                               ins32, do.float())
    for g, w in zip(got, want):
        gap = float((g.float() - w).abs().max()) / float(w.abs().max())
        assert gap <= 2.0 ** -7, gap
