"""Port parity for the Mixture-of-Experts FFN (``nn.moe``): ``moe_apply``,
its aux terms (Switch load balance, router z-loss) and its gradients
against the reference's, with the reference's weights, on the same numpy
inputs:

  * at a capacity factor where tokens are dropped and at one where none
    are (the drops counted on both sides' rule);
  * with a router tie built on purpose (two identical router columns), so
    the order ``top_k`` gives equal probabilities (the lower expert index
    first, as ``jax.lax.top_k``) decides which expert a token takes;
  * at decode's shape, T = B = 3 tokens with C = 1: the rows compete for
    expert slots.

Tolerances:
  * f32: outputs within 2e-6 + 2e-5 |ref| (XLA and torch sum the
    products in another order), aux terms within rtol 1e-6, gradients
    (of sum(y * w) + the aux terms, w.r.t. every weight and the input)
    leaf by leaf within GRAD_TOL = 1e-4 of the leaf's largest magnitude;
  * bf16 (inputs and weights in bf16, the router in f32 as the
    reference's): outputs within BF16_TOL = 1e-2 of their largest
    magnitude (a bf16 ulp is 2^-8 relative; one was measured), the
    aux terms within rtol 1e-5.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.nn import moe as jmoe  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.nn import moe  # noqa: E402

ATOL, RTOL = 2e-6, 2e-5
BF16_TOL = 1e-2
GRAD_TOL = 1e-4
D, E, K, F = 64, 8, 2, 32
# case -> (capacity factor, B, S, router tie)
CASES = {"drops": (0.5, 2, 32, False), "no_drops": (8.0, 2, 32, False),
         "tie": (1.25, 2, 32, True), "decode_c1": (1.25, 3, 1, False)}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch thread: many small operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _cfgs(cap):
    kw = dict(d_model=D, num_experts=E, top_k=K, d_ff_expert=F, num_shared=2,
              capacity_factor=cap)
    return jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)


def _inputs(case):
    cap, B, S, tie = CASES[case]
    cfg_j, cfg_t = _cfgs(cap)
    p = jax.tree.map(np.array, jax.device_get(split_params(
        jmoe.moe_init(jax.random.PRNGKey(2), cfg_j))[0]))
    if tie:                     # experts 3 and 5 route identically
        p["router"][:, 5] = p["router"][:, 3]
    x = np.random.default_rng(7).standard_normal((B, S, D)).astype(
        np.float32)
    return cfg_j, cfg_t, p, x


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _routing(cfg_t, p, x):
    """The port's routing of ``x``: chosen experts (T, k), kept mask and
    the capacity."""
    T = x.shape[0] * x.shape[1]
    xf = torch.from_numpy(x.reshape(T, D))
    probs = torch.softmax(xf @ torch.from_numpy(p["router"]), dim=-1)
    _, top_e = moe.top_k(probs, K)
    C = max(1, math.ceil(T * K / E * cfg_t.capacity_factor))
    _, _, keep = moe.dispatch(xf, top_e.reshape(-1), K, E, C)
    return top_e, keep, C


def test_top_k_orders_ties_as_reference():
    rng = np.random.default_rng(0)
    p = rng.integers(0, 4, (64, 12)).astype(np.float32) / 4.0
    vj, ij = jax.lax.top_k(jnp.asarray(p), 5)
    vt, it = moe.top_k(torch.from_numpy(p), 5)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_cases_route_as_named():
    """Each case exercises what it is named for."""
    for case, (cap, B, S, tie) in CASES.items():
        cfg_j, cfg_t, p, x = _inputs(case)
        top_e, keep, C = _routing(cfg_t, p, x)
        if case == "drops":
            assert int((~keep).sum()) > 0
        if case == "no_drops":
            assert bool(keep.all())
        if case == "tie":            # a tied pair chosen together or the 3
            both = (top_e == 3).any(-1) | (top_e == 5).any(-1)
            assert bool(both.any())
            assert not bool(((top_e == 5).any(-1)
                             & ~(top_e == 3).any(-1)).any())
        if case == "decode_c1":
            assert C == 1 and B * S == 3


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_reference(case, dtype):
    cfg_j, cfg_t, p, x = _inputs(case)
    if dtype == "bf16":
        p = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), p)
        x = x.astype(ml_dtypes.bfloat16)
    yj, aj = jax.jit(lambda p, x: jmoe.moe_apply(p, x, cfg_j))(p, x)
    yt, at = moe.moe_apply(bridge.tree(p), bridge.tensor(x), cfg_t)
    assert yt.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    assert sorted(at) == sorted(aj)
    got, want = _np(yt), _np(yj)
    if dtype == "bf16":
        gap = float(np.abs(got - want).max())
        assert gap <= BF16_TOL * float(np.abs(want).max()), gap
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    for k in aj:
        assert at[k].dtype == torch.float32
        np.testing.assert_allclose(float(at[k]), float(aj[k]),
                                   rtol=1e-6 if dtype == "f32" else 1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_gradients_match_reference(case):
    cfg_j, cfg_t, p, x = _inputs(case)
    w = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)

    def loss_j(p, x):
        y, aux = jmoe.moe_apply(p, x, cfg_j)
        return jnp.sum(y * w) + aux["moe_load_balance"] + aux["moe_z_loss"]
    gj = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(p, x)
    pt = tu.tree_map(lambda t: t.requires_grad_(True), bridge.tree(p))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(pt, xt, cfg_t)
    loss = (y * torch.from_numpy(w)).sum() + aux["moe_load_balance"] \
        + aux["moe_z_loss"]
    gt = torch.autograd.grad(loss, tu.leaves(pt) + [xt])
    want = jax.tree.leaves(gj[0]) + [gj[1]]
    assert len(gt) == len(want)
    for path, g, w_ in zip(tu.paths(pt) + [("x",)], gt, want):
        w_ = np.asarray(w_)
        gap = float(np.abs(g.numpy() - w_).max())
        assert gap <= GRAD_TOL * float(np.abs(w_).max()), (path, gap)
