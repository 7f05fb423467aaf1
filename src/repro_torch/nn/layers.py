"""Core layers: dense, embedding, norms, activations, rotary embeddings.

Each mirrors ``repro/nn/layers.py`` on bare tensors in the reference's
layouts; floating math stays in the input's dtype except where the
reference widens (the norms and RoPE compute in f32 and cast back). The
activations repeat the reference's operations in its order, one rounding
to the input's dtype each, with its constants rounded to that dtype first.
Multimodal RoPE and the causal conv wait for the architectures that use
them.
"""
from __future__ import annotations

import math
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


def layernorm_init(gen, dim: int, device="cpu"):
    del gen
    return {"scale": param(None, (dim,), "ones", device=device),
            "bias": param(None, (dim,), "zeros", device=device)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    c = x - mu
    var = (c * c).mean(dim=-1, keepdim=True)    # jnp.var: mean of squares
    x = c * torch.rsqrt(var + eps)
    return (x * p["scale"].float() + p["bias"].float()).to(dt)


# ----------------------------------------------------------- activations ---
def _const(value: float, x: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``x``'s dtype, as the reference's constants
    are (a 0-d tensor, so the product rounds once in that dtype)."""
    return torch.tensor(value, dtype=x.dtype)


def _sigmoid(x):
    """``jax.nn.sigmoid``: the logistic as XLA expands it, 1 / (1 + exp(-x))."""
    return 1.0 / (1.0 + torch.exp(-x))


def _silu(x):
    return x * _sigmoid(x)


def softplus(x):
    """``jax.nn.softplus``, which is ``jnp.logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)) at every x, as ``torch.logaddexp`` computes it.
    ``torch.nn.functional.softplus`` returns x itself above its threshold
    (20) and log1p(exp(x)) below it."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _relu(x):
    # jnp.maximum(x, 0) (NaN passes); the gradient at 0 is 0, as jax's
    return torch.relu(x)


def _relu2(x):
    r = _relu(x)
    return r * r                        # jnp.square: one product


def _gelu_tanh(x):
    """``jax.nn.gelu(x, approximate=True)`` operation by operation: the
    cube as ``x * x * x``, the constants in x's dtype (bf16: 0.0446777
    and 0.796875). ``torch.nn.functional.gelu`` rounds otherwise."""
    cube = x * x * x
    inner = _const(math.sqrt(2.0 / math.pi), x) * (
        x + _const(0.044715, x) * cube)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


#: the reference's activations; its "gelu" is jax.nn.gelu's default, the
#: tanh form, so it and "gelu_tanh" are one function
_ACTIVATIONS = {"silu": _silu, "gelu": _gelu_tanh, "relu": _relu,
                "relu2": _relu2, "gelu_tanh": _gelu_tanh}


def activation(name: str):
    """The FFN activation by the reference's name (a ``KeyError`` for any
    other, as the reference's table)."""
    return _ACTIVATIONS[name]


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


# ---------------------------------------------------- causal depthwise conv -
def causal_conv1d_init(gen, dim: int, width: int, use_bias: bool = True,
                       device="cpu"):
    p = {"kernel": param(gen, (width, dim), "normal", 1.0 / width, device)}
    if use_bias:
        p["bias"] = param(gen, (dim,), "zeros", device=device)
    return p


def causal_conv1d(p, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over a sequence. x: (batch, seq, dim), in x's
    dtype: the ``width`` shifted products summed in the reference's order
    (Python's ``sum``, from the oldest tap), then the bias."""
    width, S = p["kernel"].shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    k = p["kernel"].to(x.dtype)
    y = sum(pad[:, i:i + S, :] * k[i] for i in range(width))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def causal_conv1d_step(p, x: torch.Tensor, conv_state: torch.Tensor):
    """One decode step. x: (batch, dim); conv_state: (batch, width-1, dim),
    the last width-1 inputs. -> (y (batch, dim), conv_state), the state
    shifted by one row and ``x`` appended IN PLACE: the window is built in
    a fresh tensor first, so the shift reads nothing it has written."""
    k = p["kernel"].to(x.dtype)
    full = torch.cat([conv_state.to(x.dtype), x[:, None, :]], dim=1)
    y = torch.einsum("bwd,wd->bd", full, k)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    conv_state.copy_(full[:, 1:, :])
    return y, conv_state
