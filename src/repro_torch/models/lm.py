"""Decoder-only LM: embedding -> stack (``nn.blocks``) -> final norm ->
tied or separate readout, as ``repro/models/lm.py``. The serving half is
ported: ``lm_prefill`` (full prompt -> last-position logits + caches) and
``lm_decode_step`` (one token per row against the caches, updated in
place). The loss (``lm_loss``, ``chunked_xent``) comes with the LM
training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.nn.attention import (decode_index, packed_positions,
                                      segment_positions, std_positions)
from repro_torch.nn.blocks import (StackConfig, stack_fwd, stack_init,
                                   stack_init_cache)
from repro_torch.nn.layers import embedding_init, rmsnorm, rmsnorm_init


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm
    vocab_size: int
    stack: StackConfig
    tie_embeddings: bool = True
    scale_embed: bool = False     # gemma-style sqrt(d_model) embedding scale
    loss_chunk: int = 512
    compute_dtype: Any = torch.bfloat16
    frontend_dim: Optional[int] = None
    mrope: bool = False

    @property
    def d_model(self) -> int:
        return self.stack.d_model

    @property
    def num_layers(self) -> int:
        return self.stack.num_layers


def _check_cfg(cfg: LMConfig) -> None:
    if cfg.frontend_dim or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: frontend embeddings and multimodal RoPE come with "
            "the vlm slice of the port")


def lm_init(gen: torch.Generator, cfg: LMConfig, device="cpu"):
    _check_cfg(cfg)
    p: Dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                device=device),
        "stack": stack_init(gen, cfg.stack, device),
        "final_norm": rmsnorm_init(gen, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                      device=device)
    return p


def _embed_inputs(params, batch, cfg: LMConfig):
    """tokens (B, S) -> (B, S, d) in the compute dtype."""
    x = params["embed"]["table"].to(cfg.compute_dtype)[batch["tokens"].long()]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype)
    return x


def _readout_table(params, cfg: LMConfig):
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["unembed"]["table"])


def _positions_and_segments(batch):
    """-> (pos, segments, std, segstd): positions built here from an arange
    (or from the segment ids) are declared standard, so the flash kernel is
    reachable."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    pos = batch.get("positions")
    seg = batch.get("segment_ids")
    std = segstd = False
    if pos is None:
        if seg is not None:
            pos = packed_positions(seg)
            segstd = True
        else:
            pos = torch.arange(S, dtype=torch.int32,
                               device=tokens.device)[None].expand(B, S)
            std = True
    return pos, seg, std, segstd


def lm_prefill(params, batch, cfg: LMConfig):
    """Full-prompt forward -> (last-position logits (B, V), caches)."""
    _check_cfg(cfg)
    pos, seg, std, segstd = _positions_and_segments(batch)
    x = _embed_inputs(params, batch, cfg)
    with std_positions(std), segment_positions(segstd):
        x, caches = stack_fwd(params["stack"], x, pos, cfg.stack,
                              mode="prefill", segments=seg)
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.stack.norm_eps)
    logits = x @ _readout_table(params, cfg).to(x.dtype).T
    return logits[:, 0, :], caches


def lm_init_cache(cfg: LMConfig, batch: int, length: int,
                  dtype=torch.bfloat16, device="cpu"):
    return stack_init_cache(cfg.stack, batch, length, dtype, device)


def lm_decode_step(params, token, caches, index, cfg: LMConfig):
    """One token per row. token: (B,) int32; index: scalar or (B,)
    per-request positions. Updates ``caches`` in place -> (logits (B, V),
    caches)."""
    _check_cfg(cfg)
    B = token.shape[0]
    table = params["embed"]["table"].to(cfg.compute_dtype)
    x = table[token.long()][:, None, :]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype)
    idx = decode_index(index, B, token.device)
    x, caches = stack_fwd(params["stack"], x, idx[:, None], cfg.stack,
                          mode="decode", caches=caches, index=idx)
    x = rmsnorm(params["final_norm"], x, cfg.stack.norm_eps)
    logits = x @ _readout_table(params, cfg).to(x.dtype).T
    return logits[:, 0, :], caches
