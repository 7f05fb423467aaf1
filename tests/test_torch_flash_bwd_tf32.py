"""The flash backward's split-TF32 route (``csrc/flash_bwd_tf32.cu``), on
the CPU: the route rule, the shared memory its wrappers size from shapes
alone, and its numerics.

``bwd_route`` sends f32 calls with D and Dv multiples of 8 in [8, 256] to
the split-TF32 dQ and dK/dV kernels ("tf32"), bf16 calls at the forward's
tensor-core head dims to the bf16 tensor-core kernels ("tc"), and every
other call to the SIMT kernels, as ``fwd_route`` does for the forward
(one rule). ``bwd_tf32_smem`` mirrors the kernels'
shared memory and fits a block's 232,448 bytes at every head dim the route
takes.

The numerics: a plain-torch emulation of what the kernels compute, in f32.
Every operand x of the seven products enters as hi = tf32(x), rounded to
nearest with ties away from zero (cvt.rna.tf32.f32's rounding), and lo =
x - hi truncated to tf32; a product a b is al bh + ah bl + ah bh, each
term exact in f32 and summed in f32. P = 2^(S scale log2e - lse log2e),
0 at masked pairs; dS = P (dP - delta). Against ``flash_bwd_dq_ref`` /
``flash_bwd_dkv_ref`` and against the reference's Pallas backward in
interpret mode, within the unchanged ``flash_attention.tolerance`` (1e-5
of the largest magnitude plus 1e-5 relative). One tf32 operand a product
(hi alone) breaks it many times over: the reason for the split. The
tensor cores' own f32 sums truncate; the kernels add their long sums in
f32 instead, which the emulation's f32 sums stand for.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from test_torch_dense_archs import _one_intra_op_thread  # noqa: E402, F401

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16
SOURCE = (Path(fa.__file__).resolve().parent / "csrc" / "flash_bwd_tf32.cu")
LOG2E = 1.4426950408889634
VARIANTS = ("causal", "noncausal", "window", "segments")


# ---------------------------------------------------------------- route ---
def _rule(dtype, D, Dv):
    """The stated rule, written out apart from ``bwd_route``."""
    dims = (D, Dv)
    if dtype == BF16 and all(d % 16 == 0 and 16 <= d <= 256 for d in dims):
        return "tc"
    if dtype == F32 and all(d % 8 == 0 and 8 <= d <= 256 for d in dims):
        return "tf32"
    return "simt"


@pytest.mark.parametrize("dtype", [F32, BF16, F16], ids=str)
def test_bwd_route_at_every_head_dim(dtype):
    """Every (D, Dv) in [8, 272]^2: f32 at multiples of 8 up to 256 takes
    the split-TF32 kernels, bf16 at multiples of 16 the bf16 tensor-core
    kernels, the rest the SIMT kernels; the forward takes the same route
    (one rule)."""
    dims = range(8, 273)
    got = {(D, Dv): fa.bwd_route(dtype, D, Dv) for D in dims for Dv in dims}
    assert got == {(D, Dv): _rule(dtype, D, Dv) for D in dims for Dv in dims}
    assert all(fa.fwd_route(dtype, D, Dv) == r for (D, Dv), r in got.items())


# ---------------------------------------------------------- shared memory ---
TF32_DIMS = range(8, 257, 8)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_bwd_tf32_smem_fits_at_every_tf32_head_dim(kernel):
    """Every (D, Dv) the route takes fits a block's shared memory at the row
    tile ``bwd_rows`` gives it (64 up to head dim 128, 32 above), the
    largest at (128, 128) on 64-row tiles."""
    sizes = {(D, Dv): fa.bwd_tf32_smem(kernel, D, Dv)
             for D in TF32_DIMS for Dv in TF32_DIMS
             if fa.bwd_route(F32, D, Dv) == "tf32"}
    assert len(sizes) == len(TF32_DIMS) ** 2
    assert max(sizes.values()) == sizes[(128, 128)] <= fa.SMEM_LIMIT
    assert all(fa.bwd_rows(D, Dv) == (64 if max(D, Dv) <= 128 else 32)
               for D, Dv in sizes)


@pytest.mark.parametrize("D,dq_bytes,dkv_bytes", [
    (64, 105_728, 106_240), (128, 204_032, 204_544), (256, 200_320, 200_576)])
def test_bwd_tf32_smem_equals_the_kernel_source(D, dq_bytes, dkv_bytes):
    """The mirror gives the sizes the kernel source states (its header
    comment) at D = Dv = 64, 128 and 256."""
    assert fa.bwd_tf32_smem("dq", D, D) == dq_bytes
    assert fa.bwd_tf32_smem("dkv", D, D) == dkv_bytes
    text = SOURCE.read_text()
    stated = text[text.index("// Shared memory"):text.index("#include")]
    for n in (dq_bytes, dkv_bytes):
        assert re.search(rf"\b{n:,}\b", stated), f"{n:,} not in the source"


# ------------------------------------------------------------- numerics ---
def _tf32_round(x):
    """tf32(x) rounded to nearest, ties away from zero: add half a tf32 ulp
    to the bits and clear the 13 low ones (the kernels' ``split``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(eq, a, b, split=True):
    """einsum of f32 ``a`` and ``b`` as the kernels take it: al bh + ah bl
    + ah bh in f32 (or, without ``split``, ah bh alone)."""
    ah, bh = _tf32_round(a), _tf32_round(b)
    if not split:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def tf32_emulation(q, k, v, do, lse, delta, seg, *, causal, window,
                   split=True):
    """What the split-TF32 dQ and dK/dV compute, in plain torch ->
    (dq, dk, dv) in f32."""
    B, S, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    rep, scale = H // K, D ** -0.5
    qr = q.reshape(B, S, K, rep, D)
    dor = do.reshape(B, S, K, rep, Dv)
    idx = torch.arange(S)
    d = idx[:, None] - idx[None, :]
    kept = torch.ones((B, S, S), dtype=torch.bool)
    if causal:
        kept &= (d >= 0)[None]
    if window:
        kept &= (d < window)[None]
    if seg is not None:
        kept &= seg[:, :, None] == seg[:, None, :]
    kept = kept[:, :, None, None, :]
    rows = lambda x: x.permute(0, 2, 1).reshape(B, S, K, rep, 1)  # noqa
    s = _mm("bqkrd,bskd->bqkrs", qr, k, split)
    p = torch.where(kept, torch.exp2(s * (scale * LOG2E) - rows(lse) * LOG2E),
                    0.0)
    ds = p * (_mm("bqkrd,bskd->bqkrs", dor, v, split) - rows(delta))
    dq = _mm("bqkrs,bskd->bqkrd", ds, k, split) * scale
    dk = _mm("bqkrs,bqkrd->bskd", ds, qr, split) * scale
    dv = _mm("bqkrs,bqkrd->bskd", p, dor, split)
    return dq.reshape(q.shape), dk, dv


def _worst(got, want) -> float:
    """Largest |got - want| over its ``tolerance`` limit (<= 1 passes)."""
    gap = (got.float() - want.float()).abs()
    return float((gap / fa.tolerance(got, want)).max())


def _inputs(S, rep, D, Dv, variant, seed, B=2, K=2):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, K * rep, D), (B, S, K, D), (B, S, K, Dv),
                             (B, S, K * rep, Dv)))
    seg = None
    if variant == "segments":
        seg = np.zeros((B, S), np.int32)
        for b in range(B):
            for c in rng.choice(np.arange(1, S), 3, replace=False):
                seg[b, c:] += 1
    kw = dict(causal=variant != "noncausal",
              window=100 if variant == "window" else 0)
    return q, k, v, do, seg, kw


def _vs_plain(S, rep, D, Dv, variant, seed, split=True):
    q, k, v, do, seg, kw = _inputs(S, rep, D, Dv, variant, seed)
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    seg = None if seg is None else torch.from_numpy(seg)
    o, lse = fa.flash_attention_ref(q, k, v, seg, with_lse=True, **kw)
    delta = fa.flash_bwd_delta_ref(o, do)
    got = tf32_emulation(q, k, v, do, lse, delta, seg, split=split, **kw)
    want = (fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, seg, **kw),
            *fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, seg, **kw))
    return [_worst(g, w) for g, w in zip(got, want)]


# (D, Dv) x the four masks, with S 128 / 256 and GQA rep 1-3 spread over
# the cases
EMU_CASES = [(dims, variant, 1 + i % 3, (128, 256)[i % 2])
             for i, (dims, variant) in enumerate(
                 (dims, variant) for dims in ((16, 16), (64, 32), (32, 64))
                 for variant in VARIANTS)]


@pytest.mark.parametrize("dims,variant,rep,S", EMU_CASES, ids=[
    f"{d[0]}-{d[1]}-{v}-rep{r}-S{s}" for d, v, r, s in EMU_CASES])
def test_tf32_numerics_hold_tolerance_against_the_plain_versions(dims,
                                                                 variant,
                                                                 rep, S):
    """The split arithmetic: dq, dk and dv within
    ``flash_attention.tolerance`` of the plain versions (f32 over full
    (S, S) matrices)."""
    worst = _vs_plain(S, rep, *dims, variant, seed=rep * S + dims[0])
    assert max(worst) <= 1.0, f"worst |err| / limit (dq, dk, dv) {worst}"


@pytest.mark.parametrize("variant", ["causal", "segments"])
def test_tf32_numerics_one_operand_breaks_tolerance(variant):
    """One tf32 operand a product (hi alone, ~2^-11 a term) breaks the
    tolerance many times over in each of dq, dk and dv."""
    worst = _vs_plain(256, 3, 64, 64, variant, seed=5, split=False)
    assert min(worst) > 10.0, f"worst |err| / limit (dq, dk, dv) {worst}"


PALLAS_CASES = [((16, 16), "causal", 2), ((64, 32), "window", 1),
                ((32, 64), "segments", 3)]


@pytest.mark.parametrize("dims,variant,rep", PALLAS_CASES, ids=[
    f"{d[0]}-{d[1]}-{v}-rep{r}" for d, v, r in PALLAS_CASES])
def test_tf32_numerics_match_reference_pallas(dims, variant, rep):
    """The emulation on the reference's own residuals (its Pallas forward's
    o and lse, interpret mode) against its Pallas backward, within
    ``flash_attention.tolerance``."""
    q, k, v, do, seg, kw = _inputs(256, rep, *dims, variant, seed=rep)
    jseg = None if seg is None else jnp.asarray(seg)
    o, lse = jfa.flash_attention_fwd(q, k, v, jseg, interpret=True, **kw)
    want = jax.device_get(jfa.flash_attention_bwd(
        q, k, v, o, lse, do, jseg, interpret=True, **kw))
    t = lambda x: bridge.tensor(jax.device_get(x))   # noqa: E731
    o_t, do_t = t(o), t(do)
    got = tf32_emulation(t(q), t(k), t(v), do_t, t(lse),
                         fa.flash_bwd_delta_ref(o_t, do_t),
                         None if seg is None else t(seg), **kw)
    worst = [_worst(g, bridge.tensor(w)) for g, w in zip(got, want)]
    assert max(worst) <= 1.0, f"worst |err| / limit (dq, dk, dv) {worst}"
