"""The split-key decode and the vectorised delta of the port's CUDA kernels,
emulated in PyTorch on the CPU (no card needed).

``flash_decode_sm90.cu`` splits each (row, kv head)'s live keys over a
cluster of ``DECODE_CLUSTER`` blocks, each keeping an f32 partial softmax
(m, l, acc) over stages of ``tk`` keys, and combines the partials in rank
order. ``_split_decode`` below does the same arithmetic in f32 and is held
against the reference's ``flash_decode(..., interpret=True)`` and against
``flash_decode_ref``: in f32 at ``test_torch_attention``'s tolerances
(2e-6 + 2e-5 |ref|: the reference sums its online softmax block by block,
the plain version in one full softmax), in bf16 to one bf16 ulp (both
round one f32 result once). The launch geometry the wrapper computes
(``decode_geometry``, ``decode_split``, ``delta_geometry``) is checked to
fit the card's shared memory and to cover every live slot, and every
(b, h, s) of delta, exactly once.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from test_torch_dense_archs import _one_intra_op_thread  # noqa: E402, F401

OUT_ATOL, OUT_RTOL = 2e-6, 2e-5
N = fa.DECODE_CLUSTER


def _split_decode(q, k, v, lengths, *, tk, cluster=N, scale=None):
    """The decode kernel's arithmetic: per rank f32 (m, l, acc) over stages
    of ``tk`` keys with the finite NEG_INF, then the rank-order combine."""
    B, _, H, D = q.shape
    L, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = H // K
    scale = D ** -0.5 if scale is None else scale
    qf = q.reshape(B, K, rep, D).float() * scale
    kf, vf = k.float(), v.float()
    out = torch.empty((B, K, rep, Dv))
    for b in range(B):
        parts = []
        for first, end in fa.decode_split(int(lengths[b]), L, cluster):
            m = torch.full((K, rep), fa.NEG_INF)
            l, acc = torch.zeros((K, rep)), torch.zeros((K, rep, Dv))
            for j0 in range(first, end, tk):
                j1 = min(j0 + tk, end)
                s = torch.einsum("krd,jkd->krj", qf[b], kf[b, j0:j1])
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "krj,jkd->krd", p, vf[b, j0:j1])
                m = m_new
            parts.append((m, l, acc))
        m = parts[0][0]
        for mr, _, _ in parts[1:]:
            m = torch.maximum(m, mr)
        l, x = torch.zeros_like(m), torch.zeros((K, rep, Dv))
        for mr, lr, ar in parts:                  # rank order 0..N-1
            w = torch.exp(mr - m)
            l = l + lr * w
            x = x + ar * w[..., None]
        out[b] = x / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, 1, H, Dv).to(q.dtype)


def _within_one_bf16_ulp(got, want):
    g, w = got.float(), want.float()
    ax = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    return bool(((g - w).abs() <= torch.exp2(torch.floor(torch.log2(ax))
                                             - 7)).all())


_CASES = [((9, 3), 64, 256), ((9, 3), 64, 2048), ((4, 2), 16, 256),
          ((4, 2), 16, 2048)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _CASES,
                         ids=[f"{h}-{k}-D{d}-L{L}" for (h, k), d, L in _CASES])
def test_split_decode_matches_reference(case, dtype):
    (H, K), D, L = case
    lengths = np.array([0, 1, N - 1, N, N + 1, 77, L - 1, L], np.int32)
    B = len(lengths)
    rng = np.random.default_rng(L + H)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 1, H, D), (B, L, K, D), (B, L, K, D)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jfa.flash_decode(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                           jnp.asarray(lengths), interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    tdt = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    lens = torch.from_numpy(lengths)
    plain = fa.flash_decode_ref(qt, kt, vt, lens)
    geo = fa.decode_geometry(L, H // K, D, D, qt.element_size())
    # the wrapper's ring at this shape, and a 16-key ring of many stages
    for tk in (geo.tk, 16):
        got = _split_decode(qt, kt, vt, lens, tk=tk)
        assert got.dtype == tdt
        assert bool((got[0] == 0).all())          # length 0: exact zeros
        for want in (ref, plain):
            if dtype == "float32":
                np.testing.assert_allclose(got.numpy(), want.float().numpy(),
                                           atol=OUT_ATOL, rtol=OUT_RTOL)
            else:
                assert _within_one_bf16_ulp(got, want)


def _dims():
    """Every GQA factor up to 2048 with a Dv that keeps rep * Dv <= 2048
    (the largest, and an odd one), at head dims 1 to 256."""
    for rep in (1, 2, 3, 4, 7, 8, 16, 64, 256, 2048):
        for Dv in sorted({2048 // rep, max(1, 2048 // rep - 1), 1}):
            Dv = min(Dv, 256)
            for D in (1, 16, 20, 64, 100, 256):
                yield rep, D, Dv


@pytest.mark.parametrize("itemsize", [4, 2])
def test_decode_geometry_fits_and_covers(itemsize):
    epc = 16 // itemsize
    for L in (8, 256, 2048, 4096):
        for rep, D, Dv in _dims():
            g = fa.decode_geometry(L, rep, D, Dv, itemsize)
            assert g.smem <= fa.SMEM_LIMIT, (L, rep, D, Dv, g)
            assert g.tk >= 1 and g.stages in (1, 2)
            assert 1 <= g.cluster <= N
            assert g.cluster * 4 * (2 * rep + rep * Dv) \
                <= fa.DECODE_PARTIAL_BYTES or g.cluster == 1
            if g.stages == 1:                    # one stage holds a rank
                assert g.tk >= math.ceil(L / g.cluster)
            assert g.lpr & (g.lpr - 1) == 0 and g.lpr <= 32
            assert math.ceil(g.Dp // epc / g.lpr) <= 2   # two chunks a lane
            assert g.Dp >= D and g.Dvp >= Dv
            assert rep * g.tk * 4 <= fa.DECODE_SCORE_BYTES
    for L in (8, 256, 2048):
        tk = fa.decode_geometry(L, 3, 64, 64, itemsize).tk
        for length in range(-3, L + 4):
            seen = []
            for first, end in fa.decode_split(length, L):
                assert end - first <= math.ceil(L / N)
                for j0 in range(first, end, tk):   # the ring's stages
                    seen.extend(range(j0, min(j0 + tk, end)))
            assert seen == list(range(min(max(length, 0), L)))


def _delta_emulated(o, do):
    """delta as the kernel computes it: blocks of ts positions, a row's
    16-byte chunks lg and lg + lpr and its scalar tail on lane lg, the
    lanes' xor-shuffle tree, and the (B, H, S) runs a block writes."""
    B, S, H, Dv = o.shape
    g = fa.delta_geometry(H, Dv, o.element_size())
    lpr, nvec, ts = g.lpr, g.nvec, g.ts
    epc = 16 // o.element_size()
    x = (o.float() * do.float()).reshape(B * S * H, Dv)
    lanes = torch.zeros((B * S * H, lpr))
    for lg in range(lpr):
        for ch in (lg, lg + lpr):                  # the vector body
            if ch < nvec:
                for e in range(epc):
                    lanes[:, lg] += x[:, ch * epc + e]
        for d in range(nvec * epc + lg, Dv, lpr):  # the scalar tail
            lanes[:, lg] += x[:, d]
    w = lpr // 2
    while w:
        lanes = lanes + lanes[:, torch.arange(lpr) ^ w]
        w //= 2
    rows = lanes[:, 0].reshape(B, S, H)
    out = torch.full((B, H, S), float("nan"))
    writes = torch.zeros((B, H, S), dtype=torch.int64)
    for b in range(B):
        for s0 in range(0, S, ts):
            nts = min(ts, S - s0)
            res = rows[b, s0:s0 + nts].reshape(-1)     # [sl * H + h]
            for e in range(nts * H):
                h, sl = divmod(e, nts)
                out[b, h, s0 + sl] = res[sl * H + h]
                writes[b, h, s0 + sl] += 1
    assert bool((writes == 1).all())
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dv", [40, 36, 20, 64, 256])
def test_delta_vector_tail_split_matches_plain(Dv, dtype):
    """Dv 40 is whole 16-byte chunks in both types (10 of f32, 5 of bf16: a
    lane takes a second chunk); in bf16, rows of 36 and 20 elements are not
    whole chunks (every other row starts off a 16-byte boundary), so the
    scalar tail takes the whole row."""
    rng = np.random.default_rng(Dv)
    B, S, H = 2, 37, 9
    o, do = (torch.from_numpy(rng.standard_normal((B, S, H, Dv)).astype(
        np.float32)).to(dtype) for _ in range(2))
    got = _delta_emulated(o, do)
    want = fa.flash_bwd_delta_ref(o, do)
    assert bool(((got - want).abs() <= fa.tolerance(got, want)).all())
    g = fa.delta_geometry(H, Dv, o.element_size())
    assert g.smem == 4 * g.ts * H <= 48 * 1024
    assert g.nvec * (16 // o.element_size()) <= Dv
