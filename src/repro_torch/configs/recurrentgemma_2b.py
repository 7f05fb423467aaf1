"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000, tied and sqrt(d)-scaled embeddings, 2,894,574,080
parameters [arXiv:2402.19427 Griffin], as
``repro/configs/recurrentgemma_2b.py``: RG-LRU and local attention in the
pattern (rec, rec, attn), head_dim 256, lru_width 2560, a sliding window
of ``WINDOW``, GELU (tanh). 26 layers = 8 (rglru, rglru, local MQA)
periods + 2 trailing rglru blocks; the recurrent state is O(1) and the
attention caches are rings of at most ``WINDOW`` slots.
"""
from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.blocks import BlockDef, StackConfig
from repro_torch.nn.rglru import RGLRUConfig

SKIP_SHAPES = {}

WINDOW = 2048


def _make(periods, tail, d, H, kv, hd, ff, lru_w, vocab, window,
          impl="flash", conv_width=4):
    attn = AttnConfig(d_model=d, num_heads=H, num_kv_heads=kv, head_dim=hd,
                      rope_theta=10000.0, impl=impl)
    rg = RGLRUConfig(d_model=d, lru_width=lru_w, conv_width=conv_width)
    r = BlockDef("rglru", "dense")
    a = BlockDef("gqa", "dense", window=window)
    segments = [((r, r, a), periods)]
    if tail:
        segments.append(((r,) * tail, 1))
    stack = StackConfig(segments=tuple(segments), d_model=d, d_ff=ff,
                        attn=attn, rglru=rg, act="gelu_tanh")
    return LMConfig(name="recurrentgemma-2b", family="hybrid",
                    vocab_size=vocab, stack=stack, tie_embeddings=True,
                    scale_embed=True)


def config() -> LMConfig:
    return _make(8, 2, 2560, 10, 1, 256, 7680, 2560, 256000, WINDOW)


def reduced_config() -> LMConfig:
    return _make(1, 1, 64, 4, 1, 16, 128, 64, 512, window=8, impl="naive")
