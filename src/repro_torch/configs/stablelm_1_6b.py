"""stablelm-1.6b [dense]: 24L d_model=2048 32H (GQA kv=32, i.e. MHA)
d_ff=5632 vocab=100352, untied embeddings, about 1.64 B parameters
[hf:stabilityai/stablelm-2-1_6b], as ``repro/configs/stablelm_1_6b.py``:
RMSNorm in place of LayerNorm-with-bias and full (not 25 %-partial)
rotary, so it shares the uniform trunk.
"""
from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.blocks import BlockDef, StackConfig


def _make(L, d, H, kv, hd, ff, vocab, impl="flash"):
    attn = AttnConfig(d_model=d, num_heads=H, num_kv_heads=kv, head_dim=hd,
                      rope_theta=10000.0, impl=impl)
    stack = StackConfig(segments=(((BlockDef("gqa", "dense"),), L),),
                        d_model=d, d_ff=ff, attn=attn, act="silu")
    return LMConfig(name="stablelm-1.6b", family="dense", vocab_size=vocab,
                    stack=stack, tie_embeddings=False)


def config() -> LMConfig:
    return _make(24, 2048, 32, 32, 64, 5632, 100352)


def reduced_config() -> LMConfig:
    return _make(3, 64, 4, 4, 16, 128, 512, impl="naive")
