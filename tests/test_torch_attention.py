"""Port parity: the plain PyTorch flash forward and ragged decode
(``repro_torch.kernels.flash_attention.*_ref``, which ``kernels.ops``
runs for CPU tensors) against the reference's Pallas kernels in interpret
mode; the dispatch gates against the reference's; and GQA prefill/decode
(``nn.attention.gqa_fwd``/``gqa_decode``) with the reference's weights.

Tolerances, f32 throughout (the point here is the algorithm; the CUDA
kernels are held against these plain versions on the card):
  * outputs within 2e-6 + 2e-5 |ref| (the reference sums its online
    softmax tile by tile, the plain version in one full softmax);
  * the LSE within 2e-5 absolute (logsumexp of O(1) scores);
  * GQA through the projections and RoPE within 2e-5 + 2e-4 |ref|: torch
    and XLA evaluate sin/cos and the projection sums in another order;
  * the decode cache updates bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn.module import split_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402

OUT_ATOL, OUT_RTOL = 2e-6, 2e-5


def _qkv(B, S, H, K, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, n, D)).astype(np.float32)
               for n in (H, K, K))
    return q, k, v


def _segments(B, S, seed):
    """Non-decreasing document ids with boundaries off the 256 tiles."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, S), 3, replace=False))
        for c in cuts:
            seg[b, c:] += 1
    return seg


# (S, (H, K), D, variant): every variant at both lengths, both head
# layouts and both head dims
FWD_CASES = [
    (256, (4, 2), 16, "causal"), (512, (9, 3), 64, "causal"),
    (256, (9, 3), 64, "noncausal"), (512, (4, 2), 16, "noncausal"),
    (512, (4, 2), 64, "window"), (256, (9, 3), 16, "window"),
    (512, (9, 3), 16, "segments"), (256, (4, 2), 64, "segments"),
]


@pytest.mark.parametrize("S,hk,D,variant", FWD_CASES)
def test_flash_forward_plain_matches_reference(S, hk, D, variant):
    H, K = hk
    B = 2
    q, k, v = _qkv(B, S, H, K, D, seed=S + D + H)
    causal = variant != "noncausal"
    window = 100 if variant == "window" else 0
    seg = _segments(B, S, 7) if variant == "segments" else None
    o_j, lse_j = jfa.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if seg is None else jnp.asarray(seg), causal=causal,
        window=window, interpret=True)
    o_t, lse_t = fa.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if seg is None else torch.from_numpy(seg), causal=causal,
        window=window, with_lse=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j),
                               atol=OUT_ATOL, rtol=OUT_RTOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=2e-5,
                               rtol=0)
    # the ops entry point takes the kernel path (plain version on the CPU)
    o_ops = ops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        segments=None if seg is None else torch.from_numpy(seg),
        causal=causal, window=window or None)
    assert torch.equal(o_ops, o_t)


@pytest.mark.parametrize("hk", [(4, 2), (9, 3)])
def test_flash_decode_plain_matches_reference(hk):
    H, K = hk
    B, L, D = 6, 256, 16
    q, _, _ = _qkv(B, 1, H, K, D, seed=3)
    _, k, v = _qkv(B, L, H, K, D, seed=4)
    lengths = np.array([0, 1, L, 77, 128, 255], np.int32)
    ref = jfa.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(lengths), interpret=True)
    got = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=OUT_ATOL,
                               rtol=OUT_RTOL)
    assert (got.numpy()[0] == 0).all()          # length 0: zeros, not NaN


def test_gates_match_reference():
    B = 2
    seen = set()
    for S in (8, 255, 256, 272, 512, 1024):
        for D, Dk in ((16, 16), (64, 64), (64, 32)):
            for window in (None, 0, 64, np.int64(5)):
                for pos_kind in ("none", "std", "offset", "segments"):
                    shape_q, shape_k = (B, S, 4, D), (B, S, 2, Dk)
                    seg_j = seg_t = None
                    qp_j = qp_t = None
                    if pos_kind in ("std", "offset"):
                        p = np.broadcast_to(np.arange(S, dtype=np.int32),
                                            (B, S)) + (pos_kind == "offset")
                        qp_j, qp_t = np.asarray(p), torch.from_numpy(
                            np.ascontiguousarray(p))
                    if pos_kind == "segments":
                        seg_j = np.zeros((B, S), np.int32)
                        seg_t = torch.from_numpy(seg_j)
                    want = jops.kernel_fallback_reason(
                        shape_q, shape_k, shape_k, qp_j, qp_j, window, seg_j)
                    got = ops.kernel_fallback_reason(
                        shape_q, shape_k, shape_k, qp_t, qp_t, window, seg_t)
                    assert got == want, (S, D, Dk, window, pos_kind)
                    assert ops.kernel_shape_gate(shape_q, shape_k, shape_k) \
                        == jops.kernel_shape_gate(shape_q, shape_k, shape_k)
                    seen.add(want)
                for L in (S, 272, 2048, 7):
                    dq, dk = (B, 1, 4, D), (B, L, 2, Dk)
                    w = None if window in (None,) else window
                    assert ops.flash_decode_gate(dq, dk, w) == \
                        jops.flash_decode_gate(dq, dk, w), (dq, dk, w)
    assert "" in seen and len(seen) >= 4        # kernel and fallback paths


def _gqa_cfgs(hk, impl="flash"):
    H, K = hk
    kw = dict(d_model=64, num_heads=H, num_kv_heads=K, head_dim=16,
              rope_theta=10000.0, impl=impl)
    return jattn.AttnConfig(**kw), attn.AttnConfig(**kw)


@pytest.mark.parametrize("hk", [(4, 2), (9, 3)])
def test_gqa_prefill_and_decode_match_reference(hk):
    cfg_j, cfg_t = _gqa_cfgs(hk)
    B, S, L = 2, 256, 272
    pj = jax.device_get(split_params(
        jattn.gqa_init(jax.random.PRNGKey(1), cfg_j))[0])
    pt = bridge.tree(pj)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    def fwd_j(p, x, pos):
        with jattn.std_positions():
            return jattn.gqa_fwd(p, x, pos, cfg_j, return_cache=True)
    yj, cj = jax.jit(fwd_j)(pj, jnp.asarray(x), jnp.asarray(pos))
    pos_t = torch.from_numpy(np.ascontiguousarray(pos))
    with attn.std_positions():
        yt, ct = attn.gqa_fwd(pt, torch.from_numpy(x), pos_t, cfg_t,
                              return_cache=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-5,
                               rtol=2e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]),
                                   atol=2e-5, rtol=2e-4)

    # one ragged decode step against a full-length f32 cache
    cache = {"k": rng.standard_normal((B, L, hk[1], 16)).astype(np.float32),
             "v": rng.standard_normal((B, L, hk[1], 16)).astype(np.float32),
             "pos": np.broadcast_to(np.arange(L, dtype=np.int32),
                                    (B, L)).copy()}
    index = np.array([3, L - 1], np.int32)
    xd = rng.standard_normal((B, 1, 64)).astype(np.float32)
    yj, cj = jax.jit(lambda p, x, c, i: jattn.gqa_decode(p, x, c, i, cfg_j))(
        pj, jnp.asarray(xd), jax.tree.map(jnp.asarray, cache),
        jnp.asarray(index))
    ct = bridge.tree(cache)
    yt, ct2 = attn.gqa_decode(pt, torch.from_numpy(xd), ct,
                              torch.from_numpy(index), cfg_t)
    assert ct2 is ct                             # updated in place
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-5,
                               rtol=2e-4)
    assert (ct["pos"].numpy() == np.asarray(cj["pos"])).all()
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]),
                                   atol=2e-5, rtol=2e-4)
