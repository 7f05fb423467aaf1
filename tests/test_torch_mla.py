"""Port parity for multi-head latent attention (MLA, DeepSeek-V2):
``nn.attention.mla_fwd`` (train, and prefill with its compressed cache) and
``mla_decode`` (the absorbed form against the compressed cache, updated in
place) against the reference's, with the reference's weights, in both q
forms: the direct ``wq`` (deepseek-v2-lite) and ``wdq`` -> ``qnorm`` ->
``wuq`` (deepseek-v2-236b).

Tolerances:
  * f32: outputs and caches within 2e-5 + 2e-4 |ref|, as the GQA test
    (torch and XLA take the projection sums and sin/cos in another order);
  * bf16 (weights and inputs in bf16, as trained and served): within
    BF16_TOL = 2e-2 of the largest magnitude of the reference's tensor
    (one bf16 ulp is 2^-8 relative; a few roundings stack up); decode
    computes in f32 from the bf16 cache, as the reference;
  * positions equal; the decode writes its row in place;
  * gradients through ``mla_fwd`` (f32), leaf by leaf, within GRAD_TOL =
    1e-4 of the leaf's largest magnitude;
  * the flash path at a reduced width whose head dims are multiples of 16
    (nope 32 + rope 16, v 32; S 256, the kernels' tile), through the
    port's plain kernel versions against the reference's Pallas kernels
    in interpret mode: outputs as f32 above, gradients within GRAD_TOL.
"""
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.nn import attention as jattn  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402

ATOL, RTOL = 2e-5, 2e-4
BF16_TOL = 2e-2
GRAD_TOL = 1e-4
D_MODEL = 64
QFORMS = {"direct": None, "lora": 32}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One torch thread: many small operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _cfgs(q_lora, impl="naive", nope=16, rope=8, v=16, rank=16, heads=4):
    kw = dict(d_model=D_MODEL, num_heads=heads, q_lora_rank=q_lora,
              kv_lora_rank=rank, qk_nope_dim=nope, qk_rope_dim=rope,
              v_head_dim=v, impl=impl)
    return jattn.MLAConfig(**kw), attn.MLAConfig(**kw)


def _params(cfg_j, seed=1):
    """The reference's init with every rmsnorm scale moved off zero, so
    the norms' weights take part."""
    p = jax.device_get(split_params(
        jattn.mla_init(jax.random.PRNGKey(seed), cfg_j))[0])
    rng = np.random.default_rng(seed)
    for k in ("qnorm", "kvnorm"):
        if k in p:
            p[k]["scale"] = (0.1 * rng.standard_normal(
                p[k]["scale"].shape)).astype(np.float32)
    return p


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _close(got, want, bf16, what):
    got, want = _np(got), _np(want)
    if bf16:
        gap = float(np.abs(got - want).max())
        assert gap <= BF16_TOL * float(np.abs(want).max()), (what, gap)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=what)


def _cast(tree, bf16):
    if not bf16:
        return tree
    return jax.tree.map(lambda x: np.asarray(x).astype(ml_dtypes.bfloat16),
                        tree)


def _pos(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()


def test_mla_config_matches_reference():
    for q_lora in QFORMS.values():
        cj, ct = _cfgs(q_lora, nope=128, rope=64, v=128)
        assert ct.scale == cj.scale == (128 + 64) ** -0.5
    pj = _params(_cfgs(QFORMS["lora"])[0])
    pt = attn.mla_init(torch.Generator().manual_seed(0),
                       _cfgs(QFORMS["lora"])[1])
    assert tu.paths(bridge.tree(pj)) == tu.paths(pt)
    assert [tuple(x.shape) for x in tu.leaves(bridge.tree(pj))] == \
        [tuple(x.shape) for x in tu.leaves(pt)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("qform", sorted(QFORMS))
def test_mla_fwd_and_decode_match_reference(qform, dtype):
    """Train and prefill outputs, the prefill's compressed cache, then
    three decode steps (rows at different positions, one past a slot
    never written) against a cache of 24 slots."""
    bf16 = dtype == "bf16"
    cfg_j, cfg_t = _cfgs(QFORMS[qform])
    pj = _cast(_params(cfg_j), bf16)
    pt = bridge.tree(pj)
    B, S, L = 2, 12, 24
    rng = np.random.default_rng(3)
    x = _cast(rng.standard_normal((B, S, D_MODEL)).astype(np.float32), bf16)
    pos = _pos(B, S)
    yj = jax.jit(lambda p, x: jattn.mla_fwd(p, x, pos, cfg_j))(pj, x)
    yt = attn.mla_fwd(pt, bridge.tensor(x), torch.from_numpy(pos), cfg_t)
    _close(yt, yj, bf16, "train output")
    yj, cj = jax.jit(lambda p, x: jattn.mla_fwd(
        p, x, pos, cfg_j, return_cache=True))(pj, x)
    yt, ct = attn.mla_fwd(pt, bridge.tensor(x), torch.from_numpy(pos), cfg_t,
                          return_cache=True)
    assert sorted(ct) == sorted(cj) == ["ckv", "kr", "pos"]
    _close(yt, yj, bf16, "prefill output")
    for key in ("ckv", "kr"):
        _close(ct[key], cj[key], bf16, f"prefill cache {key}")
    np.testing.assert_array_equal(_np(ct["pos"]), np.asarray(cj["pos"]))

    cdt = jnp.bfloat16 if bf16 else jnp.float32
    cache_j = jattn.mla_init_cache(cfg_j, B, L, cdt)
    cache_t = attn.mla_init_cache(cfg_t, B, L,
                                  torch.bfloat16 if bf16 else torch.float32)
    for k in cache_j:
        assert tuple(cache_t[k].shape) == cache_j[k].shape
        assert _np(cache_t[k]).dtype == _np(cache_j[k]).dtype
    # the prefill's rows into the cache, as the engine's scatter does
    cache_j = {k: v.at[:, :S].set(cj[k].astype(v.dtype))
               for k, v in cache_j.items()}
    for k, v in cache_t.items():
        v[:, :S] = ct[k].to(v.dtype)
    decode_j = jax.jit(lambda p, x, c, i: jattn.mla_decode(p, x, c, i,
                                                           cfg_j))
    for step, index in enumerate(([S, S + 3], [S + 1, L - 1],
                                  [S + 2, 2 * L - 1])):
        xd = _cast(rng.standard_normal((B, 1, D_MODEL)).astype(np.float32),
                   bf16)
        idx = np.asarray(index, np.int32)
        yj, cache_j = decode_j(pj, xd, cache_j, jnp.asarray(idx))
        yt, c2 = attn.mla_decode(pt, bridge.tensor(xd), cache_t,
                                 torch.from_numpy(idx), cfg_t)
        assert c2 is cache_t                   # updated in place
        _close(yt, yj, bf16, f"decode step {step}")
        np.testing.assert_array_equal(_np(cache_t["pos"]),
                                      np.asarray(cache_j["pos"]))
        for key in ("ckv", "kr"):
            _close(cache_t[key], cache_j[key], bf16,
                   f"decode step {step} cache {key}")


def _grads(cfg_j, cfg_t, pj, x, with_std=False):
    """Gradients of sum(mla_fwd * w) w.r.t. the weights and the input in
    both packages (``with_std``: positions declared standard, the flash
    kernels' gate)."""
    B, S = x.shape[:2]
    pos = _pos(B, S)
    w = np.random.default_rng(9).standard_normal(
        (B, S, D_MODEL)).astype(np.float32)

    def loss_j(p, x):
        if with_std:
            with jattn.std_positions():
                y = jattn.mla_fwd(p, x, pos, cfg_j)
        else:
            y = jattn.mla_fwd(p, x, pos, cfg_j)
        return jnp.sum(y * w), y
    (_, yj), gj = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1),
                                             has_aux=True))(pj, x)
    pt = tu.tree_map(lambda t: t.requires_grad_(True), bridge.tree(pj))
    xt = torch.from_numpy(x).requires_grad_(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with attn.std_positions(with_std):
            yt = attn.mla_fwd(pt, xt, torch.from_numpy(pos), cfg_t)
        gt = torch.autograd.grad((yt * torch.from_numpy(w)).sum(),
                                 tu.leaves(pt) + [xt])
    assert not [c for c in caught if "kernel gate failed" in str(c.message)]
    return yt, yj, gt, jax.tree.leaves(gj[0]) + [gj[1]]


@pytest.mark.parametrize("qform", sorted(QFORMS))
def test_mla_fwd_gradients_match_reference(qform):
    cfg_j, cfg_t = _cfgs(QFORMS[qform])
    pj = _params(cfg_j)
    x = np.random.default_rng(4).standard_normal(
        (2, 12, D_MODEL)).astype(np.float32)
    yt, yj, gt, gj = _grads(cfg_j, cfg_t, pj, x)
    _close(yt, yj, False, "output")
    assert len(gt) == len(gj)
    for i, (g, w) in enumerate(zip(gt, gj)):
        w = np.asarray(w)
        gap = float(np.abs(g.numpy() - w).max())
        assert gap <= GRAD_TOL * float(np.abs(w).max()), (i, gap)


def test_mla_flash_path_matches_reference():
    """The direct q form at head dims nope 32 + rope 16 = 48 and v 32, S
    256: the port's flash dispatch (plain kernel versions, the autograd
    Function's backward) against the reference's Pallas kernels in
    interpret mode."""
    cfg_j, cfg_t = _cfgs(None, impl="flash", nope=32, rope=16, v=32,
                         heads=2)
    pj = _params(cfg_j)
    x = np.random.default_rng(6).standard_normal(
        (1, 256, D_MODEL)).astype(np.float32)
    yt, yj, gt, gj = _grads(cfg_j, cfg_t, pj, x, with_std=True)
    _close(yt, yj, False, "flash output")
    for i, (g, w) in enumerate(zip(gt, gj)):
        w = np.asarray(w)
        gap = float(np.abs(g.numpy() - w).max())
        assert gap <= GRAD_TOL * float(np.abs(w).max()), (i, gap)
