"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000, a pruned nemotron [arXiv:2407.14679], about 4.19 B
parameters, as ``repro/configs/minitron_4b.py``: squared ReLU, an ungated
MLP, untied embeddings.
"""
from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.blocks import BlockDef, StackConfig


def _make(L, d, H, kv, hd, ff, vocab, impl="flash"):
    attn = AttnConfig(d_model=d, num_heads=H, num_kv_heads=kv, head_dim=hd,
                      rope_theta=10000.0, impl=impl)
    stack = StackConfig(segments=(((BlockDef("gqa", "dense"),), L),),
                        d_model=d, d_ff=ff, attn=attn, act="relu2",
                        gated=False)
    return LMConfig(name="minitron-4b", family="dense", vocab_size=vocab,
                    stack=stack, tie_embeddings=False)


def config() -> LMConfig:
    return _make(32, 3072, 24, 8, 128, 9216, 256000)


def reduced_config() -> LMConfig:
    return _make(3, 64, 4, 2, 16, 160, 512, impl="naive")
