"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, tied and sqrt(d)-scaled embeddings, about 3.88 B
parameters, as ``repro/configs/gemma3_4b.py``: head_dim 256, QK-RMSNorm,
GELU (tanh), a 5:1 local:global pattern with a sliding window of
``WINDOW`` on the local layers. 34 layers = 5 periods of (5 local + 1
global) + 4 trailing local layers.
"""
from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.blocks import BlockDef, StackConfig

WINDOW = 1024


def _make(L_periods, tail, d, H, kv, hd, ff, vocab, window, impl="flash"):
    attn = AttnConfig(d_model=d, num_heads=H, num_kv_heads=kv, head_dim=hd,
                      rope_theta=1e6, qk_norm=True, impl=impl)
    loc = BlockDef("gqa", "dense", window=window)
    glob = BlockDef("gqa", "dense", window=0)
    segments = [((loc, loc, loc, loc, loc, glob), L_periods)]
    if tail:
        segments.append(((loc,) * tail, 1))
    stack = StackConfig(segments=tuple(segments), d_model=d, d_ff=ff,
                        attn=attn, act="gelu_tanh")
    return LMConfig(name="gemma3-4b", family="dense", vocab_size=vocab,
                    stack=stack, tie_embeddings=True, scale_embed=True)


def config() -> LMConfig:
    return _make(5, 4, 2560, 8, 4, 256, 10240, 262144, WINDOW)


def reduced_config() -> LMConfig:
    return _make(1, 2, 64, 4, 2, 16, 128, 512, window=8, impl="naive")
