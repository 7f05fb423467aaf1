"""Mixture-of-Experts FFN (DeepSeek-V2 style: shared + routed top-k), as
``repro/nn/moe.py``, operation by operation.

Sort-based dispatch: each token's top-k assignments are ranked within
their expert by a stable sort, dropped beyond the capacity
``C = max(1, ceil(T * k / E * capacity_factor))``, scatter-added into a
dense (E, C, d) buffer (a dropped assignment adds zeros at the clamped slot
C - 1, as the reference's), run through the experts as three batched
products over the expert axis, and combined back with the renormalized
router weights. Capacity is shared by every token of the call: at decode
(T = B) the rows of a batch compete for expert slots. The router runs in
f32; ``top_k`` keeps the lower expert index first among equal
probabilities, as ``jax.lax.top_k``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.nn.layers import activation
from repro_torch.nn.module import param


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0            # shared experts (always on), same d_ff
    capacity_factor: float = 1.25
    routed_scale: float = 1.0      # deepseek routed_scaling_factor
    act: str = "silu"
    aux_loss_coef: float = 0.001
    z_loss_coef: float = 0.001


def moe_init(gen, cfg: MoEConfig, device="cpu"):
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    scale = 1.0 / math.sqrt(d)
    p = {"router": param(gen, (d, E), "normal", scale, device),
         "w_gate": param(gen, (E, d, f), "normal", scale, device),
         "w_up": param(gen, (E, d, f), "normal", scale, device),
         "w_down": param(gen, (E, f, d), "normal", 1.0 / math.sqrt(f),
                         device)}
    if cfg.num_shared:
        fs = cfg.num_shared * f
        p["shared"] = {
            "w_gate": param(gen, (d, fs), "normal", scale, device),
            "w_up": param(gen, (d, fs), "normal", scale, device),
            "w_down": param(gen, (fs, d), "normal", 1.0 / math.sqrt(fs),
                            device)}
    return p


def _swiglu(x, wg, wu, wd, act):
    h = act(x @ wg.to(x.dtype)) * (x @ wu.to(x.dtype))
    return h @ wd.to(x.dtype)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, the
    lower index first among equals (``jax.lax.top_k``'s order; ``torch.
    topk`` leaves ties unordered)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dispatch(xf: torch.Tensor, flat_e: torch.Tensor, k: int, E: int,
             C: int):
    """Rank the (T * k,) assignments ``flat_e`` within each expert by a
    stable sort, drop those past capacity ``C`` and scatter-add the kept
    tokens' rows of ``xf`` (T, d) into an (E, C, d) buffer -> (buf, rank_c,
    keep): each assignment's clamped slot and whether it was kept. A
    dropped assignment adds zeros at slot C - 1."""
    n = flat_e.shape[0]
    sorted_e, order = torch.sort(flat_e, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank_sorted = torch.arange(n, device=xf.device) - first
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = rank < C
    rank_c = torch.clamp_max(rank, C - 1)
    token_id = torch.arange(n, device=xf.device) // k
    contrib = torch.where(keep[:, None], xf[token_id],
                          torch.zeros((), dtype=xf.dtype, device=xf.device))
    buf = torch.zeros((E, C, xf.shape[1]), dtype=xf.dtype,
                      device=xf.device).index_put((flat_e, rank_c), contrib,
                                                  accumulate=True)
    return buf, rank_c, keep


def moe_apply(p, x: torch.Tensor, cfg: MoEConfig):
    """x: (B, S, d) -> (y, aux terms {"moe_load_balance", "moe_z_loss"})."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.top_k
    act = activation(cfg.act)
    xf = x.reshape(T, d)

    # ---- router (f32) ----
    logits = xf.float() @ p["router"].float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)                            # (T, k)
    top_w = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    top_w = (top_w * cfg.routed_scale).to(x.dtype)

    # ---- aux terms (Switch load balance + router z-loss) ----
    flat_e = top_e.reshape(-1)                                # (T * k,)
    me = probs.mean(dim=0)
    ce = torch.bincount(flat_e, minlength=E).float() / (T * k)
    aux = {"moe_load_balance": cfg.aux_loss_coef * E * (me * ce).sum(),
           "moe_z_loss": cfg.z_loss_coef * torch.logsumexp(
               logits, dim=-1).square().mean()}

    C = max(1, int(math.ceil(T * k / E * cfg.capacity_factor)))
    buf, rank_c, keep = dispatch(xf, flat_e, k, E, C)

    # ---- the experts, batched over the expert axis ----
    h = act(torch.bmm(buf, p["w_gate"].to(x.dtype))) * torch.bmm(
        buf, p["w_up"].to(x.dtype))
    y_buf = torch.bmm(h, p["w_down"].to(x.dtype))             # (E, C, d)

    # ---- combine ----
    y_assign = y_buf[flat_e, rank_c] * keep.to(x.dtype)[:, None]
    y = (y_assign.reshape(T, k, d) * top_w[..., None]).sum(dim=1)
    if cfg.num_shared:
        sp = p["shared"]
        y = y + _swiglu(xf, sp["w_gate"], sp["w_up"], sp["w_down"], act)
    return y.reshape(B, S, d), aux
