"""RG-LRU recurrent block (Griffin / RecurrentGemma), as
``repro/nn/rglru.py``.

    r_t = sigmoid(W_a x_t + b_a)            # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            # input gate
    log a_t = -c * softplus(Lambda) * r_t   # c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill scan the linear recurrence h_t = a_t h_{t-1} + b_t
over the sequence in log depth (``associative_scan``: the odd/even
recursion of ``jax.lax.associative_scan``, so the products are taken in
the reference's order); decode is the exact one-step update, written into
the cache IN PLACE. The block: proj -> conv1d -> RG-LRU, gated by a
parallel GeLU (tanh) branch, then an output projection.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn.layers import (_gelu_tanh, _sigmoid, causal_conv1d,
                                   causal_conv1d_init, causal_conv1d_step,
                                   dense, dense_init, softplus)
from repro_torch.nn.module import param

_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    lru_width: int
    conv_width: int = 4


def rglru_init(gen, cfg: RGLRUConfig, device="cpu"):
    d, w = cfg.d_model, cfg.lru_width
    return {
        "wx": dense_init(gen, d, w, device=device),
        "wgate": dense_init(gen, d, w, device=device),
        "conv": causal_conv1d_init(gen, w, cfg.conv_width, device=device),
        "wa": dense_init(gen, w, w, use_bias=True, device=device),
        "wi": dense_init(gen, w, w, use_bias=True, device=device),
        # Lambda so that a^c covers [0.9, 0.999] at r ~= 1 (griffin)
        "lam": param(gen, (w,), "uniform", 1.0, device=device),
        "out": dense_init(gen, w, d, device=device),
    }


def _gates(p, x):
    """x: (..., w), the conv branch -> (a, b) of the recurrence, f32."""
    r = _sigmoid(dense(p["wa"], x).float())
    i = _sigmoid(dense(p["wi"], x).float())
    softplus_lam = softplus(p["lam"].float() + 4.0)
    log_a = -_C * softplus_lam * r                        # <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * x.float())
    return a, b


def _combine(al, bl, ar, br):
    return al * ar, ar * bl + br


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along dim 1 (``even`` one longer when
    the length is odd)."""
    n = odd.shape[1]
    pairs = torch.stack((even[:, :n], odd), dim=2).flatten(1, 2)
    return pairs if even.shape[1] == n else torch.cat((pairs, even[:, n:]),
                                                      dim=1)


def associative_scan(a, b):
    """Inclusive scan of (a, b) under (a_l, b_l), (a_r, b_r) -> (a_l a_r,
    a_r b_l + b_r) along dim 1, in log depth: ``jax.lax.associative_scan``'s
    recursion (combine adjacent pairs, scan the half, combine the even
    elements with the odd results) in plain tensor operations, so every
    product and sum is the reference's. -> (prefix a, prefix b)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat((a[:, :1], ea), dim=1)
    eb = torch.cat((b[:, :1], eb), dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_fwd(p, u: torch.Tensor, cfg: RGLRUConfig,
              return_cache: bool = False):
    """u: (B, S, d_model) -> (B, S, d_model). With ``return_cache`` also
    the decode cache after the last position: the f32 state and the last
    width-1 conv inputs."""
    x = dense(p["wx"], u)
    gate = dense(p["wgate"], u)
    xc = causal_conv1d(p["conv"], x)
    a, b = _gates(p, xc)                                  # (B, S, w) f32
    _, h = associative_scan(a, b)
    y = h.to(u.dtype) * _gelu_tanh(gate)
    out = dense(p["out"], y)
    if return_cache:
        return out, {"h": h[:, -1, :],
                     "conv": x[:, -(cfg.conv_width - 1):, :].float()}
    return out


def rglru_init_cache(cfg: RGLRUConfig, batch: int, device="cpu"):
    """The decode cache, f32 whatever the serving dtype, as the reference:
    ``h`` (B, w) and ``conv`` (B, width-1, w)."""
    return {"h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_width),
                                dtype=torch.float32, device=device)}


def rglru_decode(p, u: torch.Tensor, cache, cfg: RGLRUConfig):
    """One step. u: (B, 1, d_model). Writes the new state and conv tail
    into ``cache`` IN PLACE -> (y (B, 1, d_model), cache)."""
    x = dense(p["wx"], u[:, 0, :])
    gate = dense(p["wgate"], u[:, 0, :])
    xc, _ = causal_conv1d_step(p["conv"], x.to(cache["conv"].dtype),
                               cache["conv"])
    a, b = _gates(p, xc)
    h = a * cache["h"] + b
    cache["h"].copy_(h)
    y = h.to(u.dtype) * _gelu_tanh(gate)
    return dense(p["out"], y)[:, None, :], cache
