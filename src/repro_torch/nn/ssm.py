"""Mamba-2 SSD (state-space duality) block, chunked-scan formulation, as
``repro/nn/ssm.py``.

Per head h with state (P, N) the recurrence

    H_t = exp(a_t) H_{t-1} + dt_t * x_t B_t^T,   y_t = H_t C_t + D x_t

(a_t = dt_t * A_h <= 0) is evaluated chunk by chunk: a masked quadratic
"attention" term within each chunk plus the state carried from the chunks
before it, O(S * Q) time and O(Q^2) scores per head. A Python loop over the
S / Q chunks stands in for the reference's ``lax.scan``; the carried state
is f32.

Decode is the exact one-step recurrence against the (conv, ssm) cache,
written into the cache tensors IN PLACE: the serving engine's chunked
admission runs decode on views of a slot's rows and keeps no returned
cache.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn.layers import (_silu, causal_conv1d, causal_conv1d_init,
                                   causal_conv1d_step, dense, dense_init,
                                   rmsnorm, rmsnorm_init, softplus)
from repro_torch.nn.module import param


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    state_dim: int = 128           # N
    head_dim: int = 64             # P
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim


def ssm_init(gen, cfg: SSMConfig, device="cpu"):
    d, di, H, N, G = (cfg.d_model, cfg.d_inner, cfg.num_heads,
                      cfg.state_dim, cfg.n_groups)
    conv_dim = di + 2 * G * N
    proj_dim = 2 * di + 2 * G * N + H          # in_proj emits [z, x, B, C, dt]
    return {
        "in_proj": dense_init(gen, d, proj_dim, device=device),
        "conv": causal_conv1d_init(gen, conv_dim, cfg.conv_width,
                                   device=device),
        "A_log": param(gen, (H,), "mamba_alog", device=device),
        "D": param(gen, (H,), "ones", device=device),
        "dt_bias": param(gen, (H,), "zeros", device=device),
        "norm": rmsnorm_init(gen, di, device),
        "out_proj": dense_init(gen, di, d, device=device),
    }


def _split_proj(proj, cfg: SSMConfig):
    """-> z (..., di), xbc (..., di + 2GN), dt (..., H)."""
    di, G, N, H = cfg.d_inner, cfg.n_groups, cfg.state_dim, cfg.num_heads
    return torch.split(proj, [di, di + 2 * G * N, H], dim=-1)


def _split_xbc(xbc, cfg: SSMConfig):
    di, G, N = cfg.d_inner, cfg.n_groups, cfg.state_dim
    return torch.split(xbc, [di, G * N, G * N], dim=-1)


def _dt_and_decay(p, dt_raw):
    """-> (dt, A): dt = softplus(dt_raw + dt_bias) and A = -exp(A_log), f32."""
    dt = softplus(dt_raw.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["A_log"].float())


def _chunk_step(state, xc, Bc, Cc, ac, dtc, rep: int, mask):
    """One chunk of the scan. state (B, H, P, N); xc (B, Q, H, P); Bc, Cc
    (B, Q, G, N); ac, dtc (B, Q, H) -> (new state, y (B, Q, H, P))."""
    Bb, Q, H, _ = xc.shape
    G = Bc.shape[2]
    s = torch.cumsum(ac, dim=1)                           # (B, Q, H)
    # intra-chunk: W[q, k] = (C_q . B_k) exp(s_q - s_k) dt_k for k <= q; the
    # masked s_q - s_k are clamped BEFORE exp, so the backward sees no inf
    CB = torch.einsum("bqgn,bkgn->bgqk", Cc, Bc)          # (B, G, Q, Q)
    ds = s[:, :, None, :] - s[:, None, :, :]              # (B, Q, Q, H)
    ds = torch.where(mask[None, :, :, None], ds, -1e9)
    L = torch.exp(ds).permute(0, 3, 1, 2)                 # (B, H, Q, Q)
    # each group's CB against its ``rep`` heads, as jnp.repeat on axis 1
    W = (CB[:, :, None] * L.reshape(Bb, G, rep, Q, Q)).reshape(Bb, H, Q, Q)
    W = W * dtc.permute(0, 2, 1)[:, :, None, :]
    y_intra = torch.einsum("bhqk,bkhp->bqhp", W, xc)
    # inter-chunk: the carried state read out at each position
    Ck = Cc.repeat_interleave(rep, dim=2)                 # (B, Q, H, N)
    y_inter = torch.einsum("bqhn,bhpn->bqhp", Ck, state) \
        * torch.exp(s)[..., None]
    # state update: exp(s_Q) H + sum_k exp(s_Q - s_k) dt_k x_k B_k^T
    w_end = torch.exp(s[:, -1:, :] - s) * dtc             # (B, Q, H)
    Bk = Bc.repeat_interleave(rep, dim=2)                 # (B, Q, H, N)
    dstate = torch.einsum("bkhp,bkhn->bhpn", xc * w_end[..., None], Bk)
    state = state * torch.exp(s[:, -1, :])[:, :, None, None] + dstate
    return state, y_intra + y_inter


def ssm_fwd(p, u: torch.Tensor, cfg: SSMConfig, return_cache: bool = False):
    """u: (B, S, d_model) -> (B, S, d_model); S a multiple of the chunk.
    With ``return_cache`` also the decode cache after the last position:
    the f32 state and the last width-1 pre-activation conv inputs."""
    Bb, S, _ = u.shape
    H, P, N, G, Q = (cfg.num_heads, cfg.head_dim, cfg.state_dim,
                     cfg.n_groups, cfg.chunk)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the SSD chunk "
                         f"{Q} (pad upstream)")
    nc, rep = S // Q, H // G
    proj = dense(p["in_proj"], u)
    z, xbc_raw, dt_raw = _split_proj(proj, cfg)
    xbc = _silu(causal_conv1d(p["conv"], xbc_raw))
    xs, Bs, Cs = _split_xbc(xbc, cfg)
    dt, A = _dt_and_decay(p, dt_raw)
    a = dt * A                                            # (B, S, H)

    xh = xs.reshape(Bb, nc, Q, H, P).float()
    Bh = Bs.reshape(Bb, nc, Q, G, N).float()
    Ch = Cs.reshape(Bb, nc, Q, G, N).float()
    ah = a.reshape(Bb, nc, Q, H)
    dth = dt.reshape(Bb, nc, Q, H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=u.device).tril()
    state = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=u.device)
    ys = []
    for c in range(nc):
        state, y = _chunk_step(state, xh[:, c], Bh[:, c], Ch[:, c],
                               ah[:, c], dth[:, c], rep, mask)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bb, S, H, P)
    y = y + xh.reshape(Bb, S, H, P) * p["D"].float()[:, None]
    y = y.reshape(Bb, S, cfg.d_inner).to(u.dtype)
    y = rmsnorm(p["norm"], y * _silu(z))
    out = dense(p["out_proj"], y)
    if return_cache:
        w = cfg.conv_width
        return out, {"ssm": state,
                     "conv": xbc_raw[:, -(w - 1):, :].float()}
    return out


def ssm_init_cache(cfg: SSMConfig, batch: int, device="cpu"):
    """The decode cache, f32 whatever the serving dtype, as the reference:
    ``ssm`` (B, H, P, N) and ``conv`` (B, width-1, d_inner + 2GN)."""
    H, P, N = cfg.num_heads, cfg.head_dim, cfg.state_dim
    conv_dim = cfg.d_inner + 2 * cfg.n_groups * cfg.state_dim
    return {"ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                                dtype=torch.float32, device=device)}


def ssm_decode(p, u: torch.Tensor, cache, cfg: SSMConfig):
    """One step. u: (B, 1, d_model). Writes the new state and conv tail
    into ``cache`` IN PLACE -> (y (B, 1, d_model), cache)."""
    Bb = u.shape[0]
    H, P, N, G = cfg.num_heads, cfg.head_dim, cfg.state_dim, cfg.n_groups
    rep = H // G
    proj = dense(p["in_proj"], u[:, 0, :])
    z, xbc, dt_raw = _split_proj(proj, cfg)
    xbc_c, _ = causal_conv1d_step(p["conv"], xbc.to(cache["conv"].dtype),
                                  cache["conv"])
    x, B, C = _split_xbc(_silu(xbc_c), cfg)
    x = x.reshape(Bb, H, P).float()
    B = B.reshape(Bb, G, N).repeat_interleave(rep, dim=1).float()
    C = C.reshape(Bb, G, N).repeat_interleave(rep, dim=1).float()
    dt, A = _dt_and_decay(p, dt_raw)
    decay = torch.exp(dt * A)                             # (B, H)
    state = cache["ssm"]
    new = state * decay[:, :, None, None] + \
        (x * dt[:, :, None])[:, :, :, None] * B[:, :, None, :]
    state.copy_(new)
    y = torch.einsum("bhpn,bhn->bhp", new, C) + x * p["D"].float()[:, None]
    y = y.reshape(Bb, cfg.d_inner).to(u.dtype)
    y = rmsnorm(p["norm"], y * _silu(z))
    return dense(p["out_proj"], y)[:, None, :], cache
