"""Port parity for the LM serving path: ``lm_prefill``/``lm_decode_step``,
the cache scatter/repack, and one whole ``ServeSession`` run, against the
reference package with the reference's weights (``bridge.lm_params``).

The model is smollm-135m's shape at reduced width on the flash path
(``configs.smollm_135m.flash_test_config``: 2 layers, d 64, 4 heads, kv 2,
head_dim 16, d_ff 128, vocab 512), prompt 256 and cache 272, so both
sides take their attention kernels (the reference's Pallas kernels in
interpret mode, the port's plain versions).

Tolerances:
  * logits within LOGIT_TOL = 0.02 absolute, about 4 % of their largest
    magnitude (~0.53); the gaps seen are 0.004-0.007. Everything runs in
    bf16 as served, and torch and XLA round the bf16 projections,
    activations and RoPE after sums taken in another order: one bf16 ulp
    (2^-8 relative) here and there through two layers;
  * the cache scatter and repack bitwise (pure data movement);
  * the session's greedy tokens equal; where a token differs, the
    reference's top-2 logit margin at that position must lie within
    LOGIT_TOL (a near-tie that the rounding may flip).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smollm_135m as jconf  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeSession as JServeSession  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.train.task import LMTask as JLMTask  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import smollm_135m as conf  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import ServeConfig, ServeSession  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train.task import LMTask  # noqa: E402
from test_torch_dense_archs import _one_intra_op_thread  # noqa: E402, F401

LOGIT_TOL = 0.02
P, TOTAL, VOCAB = 256, 272, 512


def _cfgs():
    return (jconf._make(2, 64, 4, 2, 16, 128, VOCAB, impl="flash"),
            conf.flash_test_config(2))


def _params():
    cfg_j, _ = _cfgs()
    return jax.device_get(split_params(
        jlm.lm_init(jax.random.PRNGKey(0), cfg_j))[0])


def _bf16(tree):
    return jax.tree.map(lambda x: np.asarray(x).astype(ml_dtypes.bfloat16),
                        tree)


def _np(x):
    """Port tensor or reference array -> f32/int numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def test_lm_prefill_and_decode_match_reference():
    cfg_j, cfg_t = _cfgs()
    pj = _bf16(_params())
    pt = bridge.lm_params(pj)
    rng = np.random.default_rng(1)
    B = 2
    toks = rng.integers(0, VOCAB, (B, P)).astype(np.int32)
    prefill_j = jax.jit(lambda p, t: jlm.lm_prefill(p, {"tokens": t}, cfg_j))
    decode_j = jax.jit(lambda p, t, c, i: jlm.lm_decode_step(p, t, c, i,
                                                             cfg_j))
    lj, prej = prefill_j(pj, jnp.asarray(toks))
    lt, pret = lm.lm_prefill(pt, {"tokens": torch.from_numpy(toks)}, cfg_t)
    assert lt.dtype == torch.bfloat16 and tuple(lt.shape) == (B, VOCAB)
    gap = np.abs(_np(lt) - _np(lj)).max()
    assert gap <= LOGIT_TOL, f"prefill logits differ by {gap}"

    cj = jlm.lm_init_cache(cfg_j, B, TOTAL)
    ct = lm.lm_init_cache(cfg_t, B, TOTAL)
    for i in range(B):
        cj = jengine.scatter_prefill(
            cj, jax.tree.map(lambda x: x[:, i:i + 1], prej), i)
        ct = engine.scatter_prefill(
            ct, {"seg0": {"b0": {"mix": {k: v[:, i:i + 1] for k, v in
                                         pret["seg0"]["b0"]["mix"].items()}}}},
            i)
    for step in range(4):                       # teacher-forced decode
        tok = rng.integers(0, VOCAB, (B,)).astype(np.int32)
        idx = np.full((B,), P + step, np.int32)
        lj, cj = decode_j(pj, jnp.asarray(tok), cj, jnp.asarray(idx))
        lt, ct = lm.lm_decode_step(pt, torch.from_numpy(tok), ct,
                                   torch.from_numpy(idx), cfg_t)
        gap = np.abs(_np(lt) - _np(lj)).max()
        assert gap <= LOGIT_TOL, f"decode step {step}: logits differ by {gap}"
    assert (_np(ct["seg0"]["b0"]["mix"]["pos"])
            == _np(cj["seg0"]["b0"]["mix"]["pos"])).all()


def _cache_np(layers, B, L, seed):
    rng = np.random.default_rng(seed)
    kv = lambda: rng.standard_normal((layers, B, L, 2, 4)).astype(  # noqa
        ml_dtypes.bfloat16)
    return {"seg0": {"b0": {"mix": {
        "k": kv(), "v": kv(),
        "pos": rng.integers(-1, 50, (layers, B, L)).astype(np.int32)}}}}


@pytest.mark.parametrize("P_len", [5, 8, 12])
def test_scatter_prefill_and_repack_bitwise(P_len):
    """Prefill shorter than, equal to, and longer than the cache (ring)."""
    caches, pre = _cache_np(2, 3, 8, 0), _cache_np(2, 1, P_len, 1)
    want = jengine.scatter_prefill(jax.tree.map(jnp.asarray, caches),
                                   jax.tree.map(jnp.asarray, pre), 2)
    got = engine.scatter_prefill(bridge.tree(caches), bridge.tree(pre), 2)
    src, valid = np.array([2, 0, 0, 1], np.int32), np.array(
        [True, True, False, True])
    want_r = jengine.repack_caches(want, jnp.asarray(src),
                                   jnp.asarray(valid))
    got_r = engine.repack_caches(got, torch.from_numpy(src),
                                 torch.from_numpy(valid))
    for w, g in ((want, got), (want_r, got_r)):
        for key in ("k", "v", "pos"):
            a = np.asarray(w["seg0"]["b0"]["mix"][key])
            b = bridge.to_numpy(g)["seg0"]["b0"]["mix"][key]
            assert (a.view(b.dtype) == b).all(), (P_len, key)


def _margin_ok(pj, cfg_j, prompt, ref_tokens, pos, first_step, tier_at):
    """The reference's top-2 logit margin for generated token ``pos`` of a
    request admitted at ``first_step``, recomputed alone: its prefill, then
    teacher-forced decode steps on its own tokens, each with the weights of
    the tier the session ran at that step (token 0 comes from the prefill
    at ``first_step``, token d >= 1 from the decode at first_step + d - 1)."""
    prefill = jax.jit(lambda p, t: jlm.lm_prefill(p, {"tokens": t}, cfg_j))
    decode = jax.jit(lambda p, t, c, i: jlm.lm_decode_step(p, t, c, i,
                                                           cfg_j))
    params = lambda step: jengine.tier_params(pj, tier_at(step), "tpu")  # noqa
    logits, pre = prefill(params(first_step), jnp.asarray(prompt[None]))
    caches = jengine.scatter_prefill(jlm.lm_init_cache(cfg_j, 1, TOTAL),
                                     pre, 0)
    for d in range(1, pos + 1):
        logits, caches = decode(params(first_step + d - 1),
                                jnp.asarray([ref_tokens[d - 1]], jnp.int32),
                                caches, jnp.asarray([P + d - 1], jnp.int32))
    top = np.sort(_np(logits)[0])[-2:]
    return float(top[1] - top[0]) <= LOGIT_TOL


def test_serve_session_matches_reference():
    """Both sessions serve the same three prompts with the same weights:
    the first up front, two more after two steps (rung 1 -> 2, then back
    to 1 as requests finish), tier 1 first and the fp8 tier pinned after
    five steps."""
    cfg_j, cfg_t = _cfgs()
    pj = _params()
    kw = dict(prompt_len=P, total_len=TOTAL, rungs=(1, 2), tiers=(0, 1),
              ladder="tpu", max_new_tokens=6, t_ctrl=4)
    sj = JServeSession(JLMTask(cfg_j), JServeConfig(**kw), params=pj)
    st = ServeSession(LMTask(cfg_t, device="cpu"), ServeConfig(**kw),
                      params=bridge.lm_params(pj), device="cpu")
    prompts = np.random.default_rng(2).integers(0, VOCAB, (3, P))
    for sess in (sj, st):
        sess.submit({"tokens": prompts[0].astype(np.int32)})
        for _ in range(2):
            sess.step()
        for p in prompts[1:]:
            sess.submit({"tokens": p.astype(np.int32)})
        for _ in range(3):
            sess.step()
        sess.set_tier(0)
    rj, rt = sj.run(), st.run()
    assert rt["rung_history"] == rj["rung_history"]
    assert rt["tier_history"] == rj["tier_history"]
    assert [r for r, _ in rt["rung_history"]] != [0]     # the rung moved
    def tier_at(step):
        return [t for s, t in rj["tier_history"] if s <= step][-1]

    for rid, req_j in sj.results().items():
        req_t = st.results()[rid]
        assert req_t.status == req_j.status == "done"
        assert req_t.first_token_step == req_j.first_token_step
        if req_t.tokens == req_j.tokens:
            continue
        pos = next(i for i, (a, b) in enumerate(zip(req_t.tokens,
                                                    req_j.tokens)) if a != b)
        assert _margin_ok(pj, cfg_j, prompts[rid].astype(np.int32),
                          req_j.tokens, pos, req_j.first_token_step,
                          tier_at), (rid, pos)


def test_tier_params_match_reference_bitwise():
    """The tier-0 weight set: one absmax per leaf, stacked layer axis
    included (not one per layer), fp8 grid in a bf16 container; tier 1 is
    the bf16 cast."""
    pj = _params()
    pt = bridge.lm_params(pj)
    for tier in (0, 1):
        want = jax.device_get(jengine.tier_params(pj, tier, "tpu"))
        got = bridge.to_numpy(engine.tier_params(pt, tier, "tpu"))
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            w = np.asarray(w)
            assert w.shape == g.shape and (w.view(g.dtype) == g).all()


def test_decode_leaves_invalid_rows_bit_identical():
    """A decode step with ``valid`` False for a row writes nothing of it,
    as the reference's ``jnp.where(valid, new, old)``."""
    _, cfg_t = _cfgs()
    task = LMTask(cfg_t, device="cpu")
    params = bridge.lm_params(_params())
    eng = engine.ServeEngine(task, params, total_len=TOTAL, prompt_len=P,
                             rungs=(2,), tiers=(1,))
    caches = eng.init_caches(2)
    prompt = np.random.default_rng(4).integers(0, VOCAB, (1, P))
    for slot in (0, 1):
        _, caches = eng.admit(2, 1, caches, slot, {"tokens": prompt})
    before = {k: v.clone() for k, v in caches["seg0"]["b0"]["mix"].items()}
    out, caches = eng.decode(2, 1, caches, np.array([3, 3]),
                             np.array([P, P]), np.array([True, False]))
    after = caches["seg0"]["b0"]["mix"]
    for key in ("k", "v", "pos"):
        assert torch.equal(after[key][:, 1], before[key][:, 1]), key
        assert not torch.equal(after[key][:, 0], before[key][:, 0]), key
    assert eng.runs == {"decode": 1, "admit": 2, "chunk": 0, "infer": 0,
                        "repack": 0}
