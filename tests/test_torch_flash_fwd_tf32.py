"""The flash forward's split-TF32 route (``csrc/flash_fwd_tf32.cu``), on the
CPU: the one route rule of the forward and the backward, the shared memory
its wrapper sizes from shapes alone, and its numerics.

``fwd_route`` sends f32 calls with D and Dv multiples of 8 in [8, 256] to
the split-TF32 kernels ("tf32"), bf16 calls with D and Dv multiples of 16
in [16, 256] to the bf16 tensor-core kernels ("tc") and every other call
to the SIMT kernels; ``bwd_route`` is the same rule, so a call's forward
and backward take one route. ``fwd_tf32_smem`` mirrors the kernel's shared
memory and fits a block's 232,448 bytes at every head dim the route takes.

The numerics: a plain-torch emulation of what the kernel computes, in f32.
Every operand x of both products enters as hi = tf32(x), rounded to
nearest with ties away from zero, and lo = x - hi truncated to tf32; a
product a b is al bh + ah bl + ah bh, each term exact in f32 and summed in
f32. The scores are scaled to log2 units (scale log2e) and masked with the
finite NEG_INF; each q tile of 64 rows walks the needed key tiles
(``bwd_rows`` keys: 64 up to head dim 128, 32 above), and each half of a
key tile (a warp's keys) keeps its own online softmax: m, l, P = 2^(S - m)
(the kernel's ex2), O = O corr + P V with P split and P V summed apart
before it is added (the kernel's per-tile f32 flush); the halves merge at
the end. Against ``flash_attention_ref`` and the reference's Pallas
forward in interpret mode: o within the unchanged
``flash_attention.tolerance`` (1e-5 of the largest magnitude plus 1e-5
relative), the LSE within 1e-5 of 1 + its largest magnitude (the limit
``chip_smoke.py`` holds the kernel to). One tf32 operand a product (hi
alone) breaks the tolerance: the reason for the split. The tensor cores'
own f32 sums truncate; the kernel adds its long sums in f32 instead,
which the emulation's f32 sums stand for.
"""
import math
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
from test_torch_flash_bwd_tf32 import _inputs, _mm, _worst  # noqa: E402
from test_torch_flash_bwd_tf32 import \
    tf32_emulation as bwd_emulation  # noqa: E402
from test_torch_dense_archs import _one_intra_op_thread  # noqa: E402, F401

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16
SOURCE = (Path(fa.__file__).resolve().parent / "csrc" / "flash_fwd_tf32.cu")
LOG2E = 1.4426950408889634
NEG_INF = -2.0e38
VARIANTS = ("causal", "noncausal", "window", "segments")


# ---------------------------------------------------------------- route ---
def _rule(dtype, D, Dv):
    """The stated rule, written out apart from ``fwd_route``."""
    dims = (D, Dv)
    if dtype == BF16 and all(d % 16 == 0 and 16 <= d <= 256 for d in dims):
        return "tc"
    if dtype == F32 and all(d % 8 == 0 and 8 <= d <= 256 for d in dims):
        return "tf32"
    return "simt"


@pytest.mark.parametrize("dtype", [F32, BF16, F16], ids=str)
def test_fwd_and_bwd_route_are_one_rule_at_every_head_dim(dtype):
    """Every (D, Dv) in [8, 272]^2: the forward's route is the stated rule,
    and the backward's equals it."""
    dims = range(8, 273)
    got = {(D, Dv): fa.fwd_route(dtype, D, Dv) for D in dims for Dv in dims}
    assert got == {(D, Dv): _rule(dtype, D, Dv) for D in dims for Dv in dims}
    assert all(fa.bwd_route(dtype, D, Dv) == r for (D, Dv), r in got.items())


# ---------------------------------------------------------- shared memory ---
TF32_DIMS = range(8, 257, 8)


def test_fwd_tf32_smem_fits_at_every_tf32_head_dim():
    """Every (D, Dv) the route takes fits a block's shared memory: 64-key
    tiles up to head dim 128, 32-key tiles above; the largest at (256,
    256)."""
    sizes = {(D, Dv): fa.fwd_tf32_smem(D, Dv)
             for D in TF32_DIMS for Dv in TF32_DIMS
             if fa.fwd_route(F32, D, Dv) == "tf32"}
    assert len(sizes) == len(TF32_DIMS) ** 2
    assert max(sizes.values()) == sizes[(256, 256)] <= fa.SMEM_LIMIT
    # the widths both head dims pad to, and the key tile
    assert {fa.tf32_width(D, Dv) for D, Dv in sizes} == {
        32, 64, 96, 128, 192, 256}
    assert fa.tf32_width(64, 32) == fa.tf32_width(32, 64) == 64


@pytest.mark.parametrize("D,nbytes", [(64, 87_808), (128, 169_728),
                                      (256, 200_192)])
def test_fwd_tf32_smem_equals_the_kernel_source(D, nbytes):
    """The mirror gives the sizes the kernel source states (its header
    comment) at D = Dv = 64, 128 and 256."""
    assert fa.fwd_tf32_smem(D, D) == nbytes
    text = SOURCE.read_text()
    stated = text[text.index("// Shared memory"):text.index("#include")]
    assert re.search(rf"\b{nbytes:,}\b", stated), f"{nbytes:,} not stated"


# ------------------------------------------------------------- numerics ---
def _kept(B, S, seg, causal, window):
    """(B, S, S) pairs the masks keep (_tile_mask)."""
    idx = torch.arange(S)
    d = idx[:, None] - idx[None, :]
    kept = torch.ones((B, S, S), dtype=torch.bool)
    if causal:
        kept &= (d >= 0)[None]
    if window:
        kept &= (d < window)[None]
    if seg is not None:
        kept &= seg[:, :, None] == seg[:, None, :]
    return kept


def _needed(B, S, seg, causal, window, k0, bk):
    """(B, S): is key tile [k0, k0 + bk) needed by each row's q tile of 64
    (_block_needed at the kernel's tile sizes)?"""
    q0 = torch.arange(S) // 64 * 64
    need = torch.ones((B, S), dtype=torch.bool)
    if causal:
        need &= (k0 <= q0 + 63)[None]
    if window:
        need &= (k0 + bk - 1 >= q0 - (window - 1))[None]
    if seg is not None:
        need &= (seg[:, q0 + 63] >= seg[:, k0:k0 + 1]) & (
            seg[:, q0] <= seg[:, k0 + bk - 1:k0 + bk])
    return need


def fwd_emulation(q, k, v, seg, *, causal, window, split=True):
    """What the split-TF32 forward computes, in plain torch -> (o (B, S, H,
    Dv), lse (B, H, S)) in f32."""
    B, S, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    rep, scale = H // K, D ** -0.5
    bk = fa.bwd_rows(D, Dv)
    kw = bk // 2                                   # a warp's keys a tile
    qr = q.reshape(B, S, K, rep, D)
    kept = _kept(B, S, seg, causal, window)
    m = [torch.full((B, S, K, rep), NEG_INF) for _ in range(2)]
    l = [torch.zeros((B, S, K, rep)) for _ in range(2)]
    o = [torch.zeros((B, S, K, rep, Dv)) for _ in range(2)]
    for k0 in range(0, S, bk):
        need = _needed(B, S, seg, causal, window, k0, bk)[:, :, None, None]
        for half in range(2):
            sl = slice(k0 + half * kw, k0 + (half + 1) * kw)
            s = _mm("bqkrd,bskd->bqkrs", qr, k[:, sl], split) * (
                scale * LOG2E)
            s = torch.where(kept[:, :, None, None, sl], s, NEG_INF)
            mn = torch.maximum(m[half], s.amax(-1))
            corr = torch.exp2(m[half] - mn)
            p = torch.exp2(s - mn[..., None])
            pv = _mm("bqkrs,bskd->bqkrd", p, v[:, sl], split)
            l_new = l[half] * corr + p.sum(-1)
            o_new = o[half] * corr[..., None] + pv
            m[half] = torch.where(need, mn, m[half])
            l[half] = torch.where(need, l_new, l[half])
            o[half] = torch.where(need[..., None], o_new, o[half])
    mn = torch.maximum(m[0], m[1])                 # the halves merge
    fa_, fb = torch.exp2(m[0] - mn), torch.exp2(m[1] - mn)
    lc = torch.clamp_min(l[0] * fa_ + l[1] * fb, 1e-30)
    out = (o[0] * fa_[..., None] + o[1] * fb[..., None]) / lc[..., None]
    lse = mn * math.log(2.0) + torch.log(lc)
    return (out.reshape(B, S, H, Dv),
            lse.reshape(B, S, H).permute(0, 2, 1).contiguous())


def _lse_worst(got, want) -> float:
    """|got - want| over the LSE limit, 1e-5 (1 + max |want|)."""
    return float((got - want).abs().max()) / (
        1e-5 * (1 + float(want.abs().max())))


def _torch(*xs):
    return tuple(None if x is None else torch.from_numpy(x) for x in xs)


def _vs_plain(S, rep, D, Dv, variant, seed, split=True):
    q, k, v, _, seg, kw = _inputs(S, rep, D, Dv, variant, seed)
    q, k, v, seg = _torch(q, k, v, seg)
    o, lse = fwd_emulation(q, k, v, seg, split=split, **kw)
    o_r, lse_r = fa.flash_attention_ref(q, k, v, seg, with_lse=True, **kw)
    return _worst(o, o_r), _lse_worst(lse, lse_r)


# the four masks x (D, Dv), with S 256 / 512 and GQA rep 1-3 spread over
# the cases
EMU_CASES = [(dims, variant, 1 + i % 3, (256, 512)[i % 2])
             for i, (dims, variant) in enumerate(
                 (dims, variant) for dims in ((16, 16), (64, 32), (32, 64))
                 for variant in VARIANTS)] + [
    ((64, 64), "causal", 3, 512), ((64, 64), "segments", 2, 256)]


@pytest.mark.parametrize("dims,variant,rep,S", EMU_CASES, ids=[
    f"{d[0]}-{d[1]}-{v}-rep{r}-S{s}" for d, v, r, s in EMU_CASES])
def test_fwd_tf32_numerics_hold_tolerance_against_the_plain_version(
        dims, variant, rep, S):
    """The split arithmetic and the tiled online softmax: o within
    ``flash_attention.tolerance`` and the LSE within its limit of the plain
    forward (f32, full softmax)."""
    worst = _vs_plain(S, rep, *dims, variant, seed=rep * S + dims[1])
    assert max(worst) <= 1.0, f"worst |err| / limit (o, lse) {worst}"


@pytest.mark.parametrize("variant", ["causal", "segments"])
def test_fwd_tf32_numerics_one_operand_breaks_tolerance(variant):
    """One tf32 operand a product (hi alone, ~2^-11 a term) breaks the
    tolerance of o many times over."""
    worst_o, _ = _vs_plain(256, 3, 64, 64, variant, seed=5, split=False)
    assert worst_o > 10.0, f"worst |err| / limit of o {worst_o}"


PALLAS_CASES = [((16, 16), "causal", 2), ((64, 32), "window", 1),
                ((32, 64), "segments", 3)]


def _pallas_fwd(q, k, v, seg, kw):
    jseg = None if seg is None else jnp.asarray(seg)
    return jfa.flash_attention_fwd(q, k, v, jseg, interpret=True, **kw)


def _t(x):
    return bridge.tensor(jax.device_get(x))


@pytest.mark.parametrize("dims,variant,rep", PALLAS_CASES, ids=[
    f"{d[0]}-{d[1]}-{v}-rep{r}" for d, v, r in PALLAS_CASES])
def test_fwd_tf32_numerics_match_reference_pallas(dims, variant, rep):
    """The emulation against the reference's Pallas forward (interpret
    mode) on the same inputs: o within ``flash_attention.tolerance``, the
    LSE within its limit."""
    q, k, v, _, seg, kw = _inputs(256, rep, *dims, variant, seed=10 + rep)
    o_j, lse_j = _pallas_fwd(q, k, v, seg, kw)
    o, lse = fwd_emulation(*_torch(q, k, v, seg), **kw)
    worst = (_worst(o, _t(o_j)), _lse_worst(lse, _t(lse_j)))
    assert max(worst) <= 1.0, f"worst |err| / limit (o, lse) {worst}"


def test_fwd_tf32_lse_feeds_the_tf32_backward_against_reference_pallas():
    """The emulated forward's (o, lse) fed to the emulated split-TF32
    backward (``tests/test_torch_flash_bwd_tf32.py``), as the f32 autograd
    Function chains the two kernels: dq, dk, dv within
    ``flash_attention.tolerance`` of the reference's Pallas backward on
    its own Pallas forward's residuals."""
    q, k, v, do, seg, kw = _inputs(256, 3, 64, 32, "causal", seed=21)
    o_j, lse_j = _pallas_fwd(q, k, v, seg, kw)
    want = jax.device_get(jfa.flash_attention_bwd(
        q, k, v, o_j, lse_j, do, None, interpret=True, **kw))
    qt, kt, vt, dot = _torch(q, k, v, do)
    o, lse = fwd_emulation(qt, kt, vt, None, **kw)
    got = bwd_emulation(qt, kt, vt, dot, lse,
                        fa.flash_bwd_delta_ref(o, dot), None, **kw)
    worst = [_worst(g, bridge.tensor(w)) for g, w in zip(got, want)]
    assert max(worst) <= 1.0, f"worst |err| / limit (dq, dk, dv) {worst}"
