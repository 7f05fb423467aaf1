"""Port parity for the RG-LRU block (``nn/rglru.py``) and the log-depth
scan it runs against the reference's (``repro/nn/rglru.py``,
``jax.lax.associative_scan``), on the same numpy inputs and the
reference's weights (``bridge.tree``; the gate biases drawn non-zero), one
torch thread. Shapes: d_model 64, lru width 48, conv width 4; B 2, S 32.

  * ``associative_scan`` over S 1, 2, 7, 32, 37 and 64 (even, odd, and a
    single element): the prefix products a bitwise (the port repeats the
    reference's recursion, so every product is taken in its order); the
    prefix sums b within 2^-21 of the largest |b| prefix (log2 S levels of
    one rounding each): XLA contracts ``a_r * b_l + b_r`` into one FMA,
    torch rounds the product first. At S 2, one combine: the reference's
    b equals the f64-emulated fused multiply-add bitwise and the port's
    the unfused product and sum bitwise, which shows the cause. Both
    stay within 2^-20 of the sequential recurrence.
  * ``rglru_fwd`` in f32: the output within 2^-18 of its largest
    magnitude (measured 3e-7 relative), the prefill cache's h and conv
    tail (the input projection, summed in another order) within 2^-18;
    the gradient of sum(y^2) leaf by leaf
    within 2^-16 of the leaf's largest magnitude (measured 8.5e-7). In
    bf16: the output within 2^-7 of its largest magnitude (a bf16 ulp of
    the gates' and projections' inputs; measured 0.002 of 0.48), h within
    2^-9 (its f32 scan over bf16 gate inputs: measured 4.0e-4 of 0.62),
    the conv tail bitwise.
  * The gate branch is ``jax.nn.gelu``'s default, the tanh form: the
    block matches the reference and not torch's erf GELU by a margin.
  * ``rglru_decode`` after a prefill of 16, 8 teacher-forced steps in
    f32: each step's output and the final h and conv tail within 2^-18
    of their largest magnitudes, the state written in place into views of
    a larger cache; the port's prefill-then-decode equals its own scan
    over 24 positions within 2^-18.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.nn import rglru as jrg  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.nn import layers as tl  # noqa: E402
from repro_torch.nn import rglru as trg  # noqa: E402

KW = dict(d_model=64, lru_width=48, conv_width=4)
B, S = 2, 32


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    cfg_j, cfg_t = jrg.RGLRUConfig(**KW), trg.RGLRUConfig(**KW)
    pj = jax.device_get(split_params(jrg.rglru_init(jax.random.PRNGKey(0),
                                                    cfg_j))[0])
    rng = np.random.default_rng(0)
    for k in ("wa", "wi"):
        pj[k]["bias"] = (rng.standard_normal(48) * 0.5).astype(np.float32)
    u = rng.standard_normal((B, S + 8, 64)).astype(np.float32)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, pj=pj, pt=bridge.tree(pj), u=u)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _close(got, want, rel, what):
    got, want = _np(got), _np(want)
    gap = float(np.abs(got - want).max())
    assert gap <= rel * float(np.abs(want).max()), (what, gap)


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


# ---------------------------------------------------------------- scan ---
@pytest.mark.parametrize("n", [1, 2, 7, 32, 37, 64])
def test_associative_scan_matches_reference(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 16)).astype(np.float32)
    b = rng.standard_normal((2, n, 16)).astype(np.float32)
    ja, jb = jax.jit(lambda a, b: jax.lax.associative_scan(
        _combine, (a, b), axis=1))(a, b)
    ta, tb = trg.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    bound = 2.0 ** -21 * float(np.abs(np.asarray(jb)).max())
    assert np.abs(tb.numpy() - np.asarray(jb)).max() <= bound
    h, seq = np.zeros((2, 16), np.float64), []
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    seq = np.stack(seq, 1)
    for got in (tb.numpy(), np.asarray(jb)):
        assert np.abs(got - seq).max() <= 2.0 ** -20 * np.abs(seq).max()
    if n == 2:      # one combine: the reference fuses it, the port does not
        fused = (a[:, 1].astype(np.float64) * b[:, 0] + b[:, 1]).astype(
            np.float32)
        unfused = (a[:, 1] * b[:, 0]) + b[:, 1]
        np.testing.assert_array_equal(np.asarray(jb)[:, 1], fused)
        np.testing.assert_array_equal(tb.numpy()[:, 1], unfused)
        assert (fused != unfused).any()


# ------------------------------------------------------------- forward ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_fwd_and_prefill_cache_match_reference(ref, dtype):
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    uj = jnp.asarray(ref["u"][:, :S].astype(dt))
    yj, cj = jax.jit(lambda p, x: jrg.rglru_fwd(
        p, x, ref["cfg_j"], return_cache=True))(ref["pj"], uj)
    yt, ct = trg.rglru_fwd(ref["pt"], bridge.tensor(np.asarray(uj)),
                           ref["cfg_t"], return_cache=True)
    f32 = dtype == "float32"
    _close(yt, yj, 2.0 ** -18 if f32 else 2.0 ** -7, "y")
    assert sorted(ct) == sorted(cj) == ["conv", "h"]
    assert all(v.dtype == torch.float32 for v in ct.values())
    _close(ct["h"], cj["h"], 2.0 ** -18 if f32 else 2.0 ** -9, "h")
    if f32:
        _close(ct["conv"], cj["conv"], 2.0 ** -18, "conv")
    else:
        np.testing.assert_array_equal(_np(ct["conv"]), _np(cj["conv"]))


def test_gate_branch_is_the_tanh_gelu(ref):
    """Swapping the port's GELU for torch's erf form moves the block off
    the reference by far more than the bound above."""
    u = ref["u"][:, :S]
    yj = _np(jax.jit(lambda p, x: jrg.rglru_fwd(p, x, ref["cfg_j"]))(
        ref["pj"], jnp.asarray(u)))
    yt = trg.rglru_fwd(ref["pt"], torch.from_numpy(u), ref["cfg_t"])
    _close(yt, yj, 2.0 ** -18, "tanh form")
    orig = trg._gelu_tanh
    trg._gelu_tanh = torch.nn.functional.gelu
    try:
        erf = trg.rglru_fwd(ref["pt"], torch.from_numpy(u), ref["cfg_t"])
    finally:
        trg._gelu_tanh = orig
    assert np.abs(_np(erf) - yj).max() > 2.0 ** -14 * np.abs(yj).max()
    assert trg._gelu_tanh is tl._gelu_tanh


def test_rglru_gradient_matches_reference(ref):
    u = ref["u"][:, :S]
    gj = jax.device_get(jax.jit(jax.grad(lambda p, x: jnp.sum(
        jrg.rglru_fwd(p, x, ref["cfg_j"]) ** 2)))(ref["pj"], jnp.asarray(u)))
    pt = tu.tree_map(lambda t: t.clone().requires_grad_(True), ref["pt"])
    loss = (trg.rglru_fwd(pt, torch.from_numpy(u), ref["cfg_t"]) ** 2).sum()
    grads = torch.autograd.grad(loss, tu.leaves(pt))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(gj)[0],
                            grads):
        assert torch.isfinite(g).all()
        _close(g, w, 2.0 ** -16, jax.tree_util.keystr(path))


# -------------------------------------------------------------- decode ---
def test_rglru_decode_matches_reference_and_own_scan(ref):
    cfg_j, cfg_t, u = ref["cfg_j"], ref["cfg_t"], ref["u"]
    P = 16
    _, cj = jax.jit(lambda p, x: jrg.rglru_fwd(
        p, x, cfg_j, return_cache=True))(ref["pj"], jnp.asarray(u[:, :P]))
    _, ct = trg.rglru_fwd(ref["pt"], torch.from_numpy(u[:, :P]), cfg_t,
                          return_cache=True)
    big = {k: torch.zeros((2,) + tuple(v.shape)) for k, v in ct.items()}
    cache = {k: big[k][1] for k in ct}
    for k in ct:
        cache[k].copy_(ct[k])
    dec_j = jax.jit(lambda p, x, c: jrg.rglru_decode(p, x, c, cfg_j))
    ys = []
    for t in range(P, P + 8):
        yj, cj = dec_j(ref["pj"], jnp.asarray(u[:, t:t + 1]), cj)
        yt, out = trg.rglru_decode(ref["pt"], torch.from_numpy(
            u[:, t:t + 1]), cache, cfg_t)
        assert out is cache
        _close(yt, yj, 2.0 ** -18, f"decode y at {t}")
        ys.append(yt)
    for k in cache:
        _close(big[k][1], cj[k], 2.0 ** -18, f"decode {k}")
        assert not big[k][0].any()
    full = trg.rglru_fwd(ref["pt"], torch.from_numpy(u[:, :P + 8]), cfg_t)
    _close(torch.cat(ys, dim=1), full[:, P:], 2.0 ** -18, "own scan")
