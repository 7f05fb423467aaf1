"""Port parity: the plain PyTorch fused-update phases
(``repro_torch.kernels.fused_update.*_ref``, which ``kernels.ops`` runs for
CPU tensors) against the reference Pallas kernels in interpret mode, on the
same numpy inputs.

Tolerances: per-layer counts and absmax are bitwise; per-layer sum and
sum_sq are within rtol 1e-5 (the two sum the rows in another order). The
apply phase runs over sgdm/adamw, nesterov, weight decay, both ladders,
f32/bf16/f16 copies, stochastic rounding and the keep flag — including
tpu-ladder values past 464, where the reference's fp8 cast gives NaN and
torch's own cast would saturate. XLA on the CPU contracts ``a * b + c``
into fused multiply-adds (the port, like the CUDA kernel, rounds after
every operation), so where a term is contracted the two differ by the one
rounding the FMA skips: each moment is held within 2^-22 of the summed
magnitudes of its terms (sgdm: |mu*m| + |g| + |wd*p|; adamw: b1|m| +
(1-b1)|g| and b2*v + (1-b2)*g^2), and the master within 2^-21 *
(|p| + |p_new|), the scale of the update it absorbs. Where the masters
agree bitwise (every row with lr = 0, and most others) the compute copy is
bitwise too, NaN compared equal to NaN; elsewhere it is within one step of
its tier's grid, and the copy's per-layer absmax within 1 f32 ulp.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import fused_update as jfu  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import fused_update as fu  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_dense_archs import _one_intra_op_thread  # noqa: E402, F401

N = 512
TILE = 256


def _np(t):
    return t.float().numpy() if t.dtype != torch.float32 else t.numpy()


def _stats_inputs(rows, L, dtype, seed=0):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((rows, N)) * 3.0).astype(np.float32)
    g[5, 7] = np.inf
    g[300, 0] = -np.inf
    g[301, 511] = np.nan
    g[700, 100:110] = np.nan
    ids = rng.integers(0, L - 1, rows).astype(np.int32)   # layer L-1 empty
    ids[rows - 50:] = 0                                   # tail pad rows
    gj = jnp.asarray(g).astype(dtype)
    return np.asarray(gj.astype(jnp.float32)), gj, ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_stats_plain_matches_reference(dtype):
    rows, L = 3 * TILE, 5
    g32, gj, ids = _stats_inputs(rows, L, getattr(jnp, dtype))
    ref = jfu.fused_stats(gj, jnp.asarray(ids.reshape(-1, TILE)), L,
                          interpret=True)
    gt = bridge.tensor(np.asarray(gj))
    out = ops.fused_stats(gt, torch.from_numpy(ids.reshape(-1, TILE)), L)
    (s, ss, mx, nf), (rs, rss, rmx, rnf) = out, ref
    np.testing.assert_array_equal(nf.numpy(), np.asarray(rnf))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(rmx))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(ss.numpy(), np.asarray(rss), rtol=1e-5)
    assert float(mx[L - 1]) == 0.0 and float(nf.sum()) == 13.0


# (name, OptSpec kwargs)
_OPTS = {
    "sgdm": dict(kind="sgdm", momentum=0.9),
    "sgdm_nesterov_wd": dict(kind="sgdm", momentum=0.9, nesterov=True,
                             weight_decay=1e-4),
    "adamw_wd": dict(kind="adamw", b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=1e-2),
}
# (container dtype, stochastic rounding)
_CASTS = [("float32", False), ("bfloat16", False), ("bfloat16", True),
          ("float16", False)]


def _apply_inputs(rows, L, adam, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    g, p = f(rows, N), f(rows, N) * 2.0
    m = f(rows, N) * 0.1
    v = np.abs(f(rows, N)) * 0.01 if adam else None
    # tpu-ladder overflow probes: with qs = 1 on row 3, |p| lands past the
    # fp8 range (reference: NaN), on it (464 ties to 448) and just below
    p[3, :6] = [500.0, -470.0, 464.0, 463.9, 448.0, -1000.0]
    ids = rng.integers(0, L, rows).astype(np.int32)
    lr = np.full(rows, 1e-2, np.float32)
    lr[::7] = 0.0
    lr[3] = 0.0
    code = rng.integers(0, 3, rows).astype(np.int32)
    code[3] = 0
    qs = (448.0 / rng.uniform(1.0, 8.0, rows)).astype(np.float32)
    qs[3] = 1.0
    meta = lambda a: a.reshape(-1, TILE)
    return g, p, m, v, meta(ids), meta(lr), meta(code), meta(qs)


def _ulps(a, b):
    """Distance in f32 units in the last place (sign-magnitude order)."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _assert_apply_close(out, ref, inputs, spec_kw, gscale, msg):
    g, p_old, m_old, v_old, lr = inputs
    p, m, v, cp, pmax = (None if t is None else _np(t) for t in out)
    rp, rm, rv, rcp, rpmax = (None if t is None else np.asarray(t, np.float32)
                              for t in ref)
    ga = np.abs(g.astype(np.float64) * gscale)
    wd = spec_kw.get("weight_decay", 0.0)
    if spec_kw["kind"] == "adamw":
        m_terms = spec_kw["b1"] * np.abs(m_old) + (1 - spec_kw["b1"]) * ga
        v_terms = spec_kw["b2"] * v_old + (1 - spec_kw["b2"]) * ga * ga
    else:
        m_terms = spec_kw["momentum"] * np.abs(m_old) + ga + wd * np.abs(p_old)
        v_terms = None
    # non-finite gradient lanes make NaN/inf moments in both: equal there
    fin = np.isfinite(rm)
    np.testing.assert_array_equal(m[~fin], rm[~fin], err_msg=f"m {msg}")
    assert np.all(np.abs(m - rm)[fin] <= 2.0 ** -22 * m_terms[fin]), \
        f"m {msg}"
    assert (v is None) == (rv is None)
    if v is not None:
        fin = np.isfinite(rv)
        np.testing.assert_array_equal(v[~fin], rv[~fin], err_msg=f"v {msg}")
        assert np.all(np.abs(v - rv)[fin] <= 2.0 ** -22 * v_terms[fin]), \
            f"v {msg}"
    assert np.all(np.abs(p - rp) <= 2.0 ** -21 * (np.abs(p_old) + np.abs(rp))
                  ), f"p {msg}"
    same = p.view(np.int32) == rp.view(np.int32)
    assert same[lr.reshape(-1) == 0].all(), f"p (lr=0 rows) {msg}"
    np.testing.assert_array_equal(cp[same], rcp[same], err_msg=f"cp {msg}")
    # a master one rounding apart can land the copy one grid step over
    # (fp8: 2^-3)
    diff = ~same & ~(np.isnan(cp) & np.isnan(rcp))
    assert np.all(np.abs(cp[diff] - rcp[diff])
                  <= 0.125 * np.abs(rcp[diff]) + 1e-30), f"cp {msg}"
    assert _ulps(pmax, rpmax).max() <= 1, f"p_amax {msg}"


@pytest.mark.parametrize("cast", _CASTS, ids=lambda c: f"{c[0]}-sr{int(c[1])}")
@pytest.mark.parametrize("ladder", ["gpu", "tpu"])
@pytest.mark.parametrize("opt", list(_OPTS))
def test_fused_apply_plain_matches_reference(opt, ladder, cast):
    cp_name, sr = cast
    rows, L = 2 * TILE, 3
    spec_kw = _OPTS[opt]
    adam = spec_kw["kind"] == "adamw"
    g, p, m, v, ids, lr, code, qs = _apply_inputs(rows, L, adam)
    jspec = jfu.OptSpec(**spec_kw)
    spec = fu.OptSpec(**spec_kw)
    jcp = getattr(jnp, cp_name)
    tcp = getattr(torch, cp_name)
    for keep in (1.0, 0.0):
        gk = g.copy()
        if not keep:
            gk[9, 9] = np.inf                     # the skipped step's cause
        scal = np.asarray([0.5, keep, 0.19, 0.0975, 12345.0], np.float32)
        ref = jfu.fused_apply(
            jnp.asarray(gk), jnp.asarray(p), jnp.asarray(m),
            None if v is None else jnp.asarray(v), jnp.asarray(scal),
            jnp.asarray(ids), jnp.asarray(lr), jnp.asarray(code),
            jnp.asarray(qs), spec=jspec, ladder=ladder, cp_dtype=jcp,
            num_layers=L, interpret=True, sr=sr)
        T = torch.from_numpy
        out = ops.fused_apply(
            T(gk), T(p), T(m), None if v is None else T(v), T(scal), T(ids),
            T(lr), T(code), T(qs), spec=spec, ladder=ladder, cp_dtype=tcp,
            num_layers=L, sr=sr)
        _assert_apply_close(out, ref, (gk, p, m, v, lr), spec_kw, scal[0],
                            f"keep={keep}")
        if ladder == "tpu" and cp_name != "float16" and keep:
            cp_row = _np(out[3])[3, :6]
            # 500 / -470 / -1000 lie past 464: NaN, like the reference
            assert np.isnan(cp_row[[0, 1, 5]]).all(), cp_row


def test_fp8_round_gives_nan_past_464():
    y = torch.tensor([470.0, 500.0, float("inf"), -465.0, 464.0, 460.0,
                      -448.0])
    got = fu._fp8_round(y)
    assert torch.isnan(got[:4]).all()
    assert got[4:].tolist() == [448.0, 448.0, -448.0]
    want = np.asarray(jnp.asarray(y.numpy()).astype(jnp.float8_e4m3fn
                                                    ).astype(jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)


# the seed reaches the kernel as the f32 step count: values f32 holds
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 256])
def test_sr_bits_match_reference(seed):
    rows = 2 * TILE
    bits = fu._sr_bits(rows, torch.tensor(float(seed)))
    for tile in range(rows // TILE):
        want = np.asarray(jfu._sr_bits(tile, jnp.uint32(seed)))
        np.testing.assert_array_equal(
            bits[tile * TILE:(tile + 1) * TILE].numpy().astype(np.uint32),
            want)


def test_seed_compute_and_cast_scales_match_reference():
    from repro.core.grouping import flat_grouping as jflat
    from repro.kernels.layout import SlabView as JSlabView
    from repro_torch.core.grouping import flat_grouping
    from repro_torch.kernels.layout import SlabView
    rng = np.random.default_rng(3)
    tree = {"a": {"w": rng.standard_normal((300, 40)).astype(np.float32)},
            "b": {"w": (rng.standard_normal((64,)) * 900).astype(np.float32)},
            "c": {"w": np.zeros((7,), np.float32)}}
    jt = {k: {"w": jnp.asarray(v["w"])} for k, v in tree.items()}
    tt = bridge.tree(tree)
    jview = JSlabView.build(jt, jflat(jt))
    view = SlabView.build(tt, flat_grouping(tt))
    codes = np.asarray([0, 0, 1], np.int32)
    for ladder in ("gpu", "tpu"):
        want = jfu.seed_compute(jview, jt, jnp.asarray(codes), ladder,
                                jnp.bfloat16, slab=True)
        got = fu.seed_compute(view, tt, torch.from_numpy(codes), ladder,
                              torch.bfloat16, slab=True)
        np.testing.assert_array_equal(got["p_amax"].numpy(),
                                      np.asarray(want["p_amax"]))
        np.testing.assert_array_equal(_np(got["slab"]),
                                      np.asarray(want["slab"], np.float32))
        np.testing.assert_array_equal(
            fu.cast_scales(got["p_amax"]).numpy(),
            np.asarray(jfu.cast_scales(want["p_amax"])))


def test_wrappers_route_cuda_tensors_to_the_kernel_only():
    """A non-CPU tensor never reaches the plain version: it goes to the
    kernel wrapper, whose checks raise here (no card)."""
    g = torch.zeros((TILE, N), device="meta")
    rl = torch.zeros((1, TILE), dtype=torch.int32, device="meta")
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_stats(g, rl, 1)
    assert ops.LAUNCHES == before
