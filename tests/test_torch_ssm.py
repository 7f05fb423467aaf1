"""Port parity for the Mamba-2 SSD block (``nn/ssm.py``), the causal conv
(``nn/layers.causal_conv1d*``) and the two init kinds it brings
(``nn/module.param``: ``mamba_alog``, ``uniform``) against the reference's
(``repro/nn/ssm.py``, ``repro/nn/layers.py``), on the same numpy inputs and
the reference's weights (``bridge.tree``), one torch thread.

Shapes: d_model 64, state 16, head dim 16, expand 2 (d_inner 128, 8
heads), two groups (so each group's B and C serve four heads), conv width
4, chunk 8; B 2, S 32 (four chunks).

  * The inits: ``ssm_init`` on ``meta`` has the reference's paths and
    shapes; drawn, ``A_log`` lies in [0, log 16) (log(1 + 15 U)), ``D`` is
    ones, ``dt_bias`` and the conv bias zeros, the conv kernel a truncated
    normal of scale 1/width; ``uniform`` draws LeCun-uniform within
    sqrt(3 / fan_in), or within the given scale.
  * ``causal_conv1d`` in bf16 bitwise (every product and sum rounds to
    bf16 in the reference's order); in f32 within 2^-20 of the largest
    |term| sum (XLA contracts a product and the running sum into one FMA);
    the step form in f32 within the same bound, its new tail bitwise and
    written into the given state in place.
  * ``ssm_fwd`` in f32: the output within 2^-16 of its largest magnitude
    (the einsums sum in other orders: measured 3e-7 relative), the
    prefill cache (state, conv tail) within 2^-16 of each leaf's largest;
    the gradient of sum(y^2) leaf by leaf within 2^-14 of the leaf's
    largest magnitude (measured 3.7e-6). In bf16 (as trained and served):
    the output within 2^-6 of its largest magnitude (a bf16 ulp of the
    projections, rounded after sums in other orders; measured 0.0156 of
    3.45), the conv tail bitwise, the state within 2^-16.
  * ``ssm_decode``, prefill of 16 then 8 teacher-forced steps in f32:
    each step's output within 2^-16 of its largest magnitude, the state
    and conv tail within 2^-16 of each leaf's largest; the port's own
    prefill-then-decode equals its ``ssm_fwd`` over all 24 positions
    within 2^-14 (the chunked scan against the recurrence: one algorithm
    against another).
  * In place: the decode writes the state and the shifted conv tail into
    the cache tensors it is given, views of a larger cache included (as
    ``ServeEngine.chunk_admit`` passes), and returns the same tensors.
  * ``S % chunk != 0`` raises ``ValueError`` (the reference asserts).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.nn import layers as jl  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.nn import layers as tl  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402
from repro_torch.nn.module import param  # noqa: E402

KW = dict(d_model=64, state_dim=16, head_dim=16, expand=2, n_groups=2,
          conv_width=4, chunk=8)
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
    cfg_j, cfg_t = jssm.SSMConfig(**KW), tssm.SSMConfig(**KW)
    pj = jax.device_get(split_params(jssm.ssm_init(jax.random.PRNGKey(0),
                                                   cfg_j))[0])
    u = np.random.default_rng(0).standard_normal((B, S + 8, 64)).astype(
        np.float32)
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


# ---------------------------------------------------------------- inits --
def test_init_shapes_and_kinds(ref):
    want = jax.eval_shape(lambda: split_params(jssm.ssm_init(
        jax.random.PRNGKey(0), ref["cfg_j"]))[0])
    got = tssm.ssm_init(None, ref["cfg_t"], device="meta")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [tuple(str(getattr(k, "key", k)) for k in path)
            for path, _ in flat] == tu.paths(got)
    assert [tuple(s.shape) for _, s in flat] == \
        [tuple(t.shape) for t in tu.leaves(got)]
    p = tssm.ssm_init(torch.Generator().manual_seed(0), ref["cfg_t"])
    assert p["A_log"].min() >= 0 and p["A_log"].max() < math.log(16.0)
    assert torch.equal(p["D"], torch.ones(8))
    assert not p["dt_bias"].any() and not p["conv"]["bias"].any()
    k = p["conv"]["kernel"]
    assert k.shape == (4, 128 + 2 * 2 * 16) and k.abs().max() <= 0.5
    gen = torch.Generator().manual_seed(1)
    lecun = param(gen, (300, 7), "uniform")
    lim = math.sqrt(3.0 / 300)
    assert lecun.abs().max() <= lim and lecun.abs().max() > 0.9 * lim
    lam = param(gen, (4096,), "uniform", 1.0)
    assert lam.min() >= -1.0 and lam.max() < 1.0 and lam.abs().max() > 0.99
    alog = param(gen, (4096,), "mamba_alog")
    assert alog.min() >= 0 and alog.max() > 0.99 * math.log(16.0)
    assert param(gen, (3,), "uniform", device="meta").device.type == "meta"


# ----------------------------------------------------------- causal conv --
def _conv_params():
    cp = jax.device_get(split_params(jl.causal_conv1d_init(
        jax.random.PRNGKey(1), 48, 4))[0])
    cp["bias"] = np.random.default_rng(2).standard_normal(48).astype(
        np.float32)
    return cp


def test_causal_conv1d_matches_reference():
    cp = _conv_params()
    x = np.random.default_rng(3).standard_normal((B, S, 48)).astype(
        np.float32)
    terms = np.abs(x).max() * np.abs(cp["kernel"]).sum(0).max() + \
        np.abs(cp["bias"]).max()
    for dt in (ml_dtypes.bfloat16, np.float32):
        xj = jnp.asarray(x.astype(dt))
        want = jax.jit(jl.causal_conv1d)(cp, xj)
        got = tl.causal_conv1d(bridge.tree(cp), bridge.tensor(np.asarray(xj)))
        if dt == np.float32:
            assert np.abs(_np(got) - _np(want)).max() <= 2.0 ** -20 * terms
        else:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(got), _np(want))
    state = np.random.default_rng(4).standard_normal((B, 3, 48)).astype(
        np.float32)
    yj, sj = jax.jit(jl.causal_conv1d_step)(cp, jnp.asarray(x[:, 0]),
                                            jnp.asarray(state))
    st = torch.from_numpy(state.copy())
    yt, out = tl.causal_conv1d_step(bridge.tree(cp), torch.from_numpy(
        x[:, 0]), st)
    assert out is st
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(st.numpy()[:, :2], state[:, 1:])
    assert np.abs(_np(yt) - _np(yj)).max() <= 2.0 ** -20 * terms


# ------------------------------------------------------------- ssm_fwd ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_fwd_and_prefill_cache_match_reference(ref, dtype):
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    uj = jnp.asarray(ref["u"][:, :S].astype(dt))
    yj, cj = jax.jit(lambda p, x: jssm.ssm_fwd(
        p, x, ref["cfg_j"], return_cache=True))(ref["pj"], uj)
    yt, ct = tssm.ssm_fwd(ref["pt"], bridge.tensor(np.asarray(uj)),
                          ref["cfg_t"], return_cache=True)
    assert yt.dtype == (torch.float32 if dtype == "float32"
                        else torch.bfloat16)
    _close(yt, yj, 2.0 ** -16 if dtype == "float32" else 2.0 ** -6, "y")
    assert sorted(ct) == sorted(cj) == ["conv", "ssm"]
    for k in ct:
        assert ct[k].dtype == torch.float32
        assert tuple(ct[k].shape) == tuple(cj[k].shape)
    _close(ct["ssm"], cj["ssm"], 2.0 ** -16, "ssm")
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(ct["conv"]), _np(cj["conv"]))
    else:
        _close(ct["conv"], cj["conv"], 2.0 ** -16, "conv")


def test_ssm_gradient_matches_reference(ref):
    u = ref["u"][:, :S]
    gj = jax.device_get(jax.jit(jax.grad(lambda p, x: jnp.sum(
        jssm.ssm_fwd(p, x, ref["cfg_j"]) ** 2)))(ref["pj"], jnp.asarray(u)))
    pt = tu.tree_map(lambda t: t.clone().requires_grad_(True), ref["pt"])
    loss = (tssm.ssm_fwd(pt, torch.from_numpy(u), ref["cfg_t"]) ** 2).sum()
    grads = torch.autograd.grad(loss, tu.leaves(pt))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(gj)[0],
                            grads):
        assert torch.isfinite(g).all()
        _close(g, w, 2.0 ** -14, jax.tree_util.keystr(path))


def test_ssm_fwd_needs_whole_chunks(ref):
    with pytest.raises(ValueError, match="chunk"):
        tssm.ssm_fwd(ref["pt"], torch.zeros((1, 12, 64)), ref["cfg_t"])


# ------------------------------------------------------------ decode ----
def test_ssm_decode_matches_reference_and_own_scan(ref):
    """Prefill 16, then 8 teacher-forced steps, in f32."""
    cfg_j, cfg_t, u = ref["cfg_j"], ref["cfg_t"], ref["u"]
    P = 16
    _, cj = jax.jit(lambda p, x: jssm.ssm_fwd(
        p, x, cfg_j, return_cache=True))(ref["pj"], jnp.asarray(u[:, :P]))
    _, ct = tssm.ssm_fwd(ref["pt"], torch.from_numpy(u[:, :P]), cfg_t,
                         return_cache=True)
    # the decode cache lives in a larger tensor, as a stacked cache's row
    big = {k: torch.zeros((3,) + tuple(v.shape)) for k, v in ct.items()}
    cache = {k: big[k][1] for k in ct}
    for k in ct:
        cache[k].copy_(ct[k])
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    dec_j = jax.jit(lambda p, x, c: jssm.ssm_decode(p, x, c, cfg_j))
    ys = []
    for t in range(P, P + 8):
        yj, cj = dec_j(ref["pj"], jnp.asarray(u[:, t:t + 1]), cj)
        yt, out = tssm.ssm_decode(ref["pt"], torch.from_numpy(
            u[:, t:t + 1]), cache, cfg_t)
        assert out is cache and all(cache[k].data_ptr() == ptrs[k]
                                    for k in cache)
        _close(yt, yj, 2.0 ** -16, f"decode y at {t}")
        ys.append(yt)
    for k in cache:
        _close(cache[k], cj[k], 2.0 ** -16, f"decode {k}")
        assert not big[k][0].any() and not big[k][2].any()
    full = tssm.ssm_fwd(ref["pt"], torch.from_numpy(u[:, :P + 8]), cfg_t)
    _close(torch.cat(ys, dim=1), full[:, P:], 2.0 ** -14, "own scan")
