"""Core layers: dense, embedding, RMSNorm, activations, rotary embeddings.

Each mirrors ``repro/nn/layers.py`` on bare tensors in the reference's
layouts; floating math stays in the input's dtype except where the
reference widens (RMSNorm and RoPE compute in f32 and cast back).
Multimodal RoPE, LayerNorm and the causal conv wait for the architectures
that use them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.nn.module import param


# ---------------------------------------------------------------- dense ----
def dense_init(gen, in_dim: int, out_dim: int, use_bias: bool = False,
               scale: Optional[float] = None, device="cpu"):
    p = {"kernel": param(gen, (in_dim, out_dim), "normal", scale, device)}
    if use_bias:
        p["bias"] = param(gen, (out_dim,), "zeros", device=device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


# ------------------------------------------------------------ embedding ----
def embedding_init(gen, vocab: int, dim: int, scale: Optional[float] = None,
                   device="cpu"):
    return {"table": param(gen, (vocab, dim), "embed",
                           scale if scale is not None else 0.02, device)}


def embed(p, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return p["table"].to(dtype)[ids.long()]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Tied readout: (..., embed) @ (embed, vocab)."""
    return x @ p["table"].to(x.dtype).T


# ---------------------------------------------------------------- norms ----
def rmsnorm_init(gen, dim: int, device="cpu"):
    del gen
    return {"scale": param(None, (dim,), "zeros", device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    # gemma-style (1 + scale) parameterization: zeros-init == identity
    return (x * (1.0 + p["scale"].float())).to(dt)


# ----------------------------------------------------------- activations ---
def _silu(x):
    # x * sigmoid(x), each rounded to x's dtype, as the reference computes
    return x * torch.sigmoid(x)


def activation(name: str):
    """The FFN activation; the ported architectures use SiLU (gelu, relu
    and relu2 come with the architectures that use them)."""
    if name != "silu":
        raise NotImplementedError(f"activation {name!r} is not ported yet")
    return _silu


# ------------------------------------------------------------------ rope ---
def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int32.

    The "split-half" convention (rotate_half), matching llama."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # (half,)
    ang = positions[..., None].float() * freqs              # (..., seq, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., seq, 1, h)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
