"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152,
tied embeddings, about 134.5 M parameters (llama architecture,
HuggingFaceTB/SmolLM-135M), as ``repro/configs/smollm_135m.py``.
"""
from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.blocks import BlockDef, StackConfig


def _make(L, d, H, kv, hd, ff, vocab, impl="flash"):
    attn = AttnConfig(d_model=d, num_heads=H, num_kv_heads=kv, head_dim=hd,
                      rope_theta=10000.0, impl=impl)
    stack = StackConfig(segments=(((BlockDef("gqa", "dense"),), L),),
                        d_model=d, d_ff=ff, attn=attn, act="silu")
    return LMConfig(name="smollm-135m", family="dense", vocab_size=vocab,
                    stack=stack, tie_embeddings=True)


def config() -> LMConfig:
    return _make(30, 576, 9, 3, 64, 1536, 49152)


def reduced_config() -> LMConfig:
    return _make(4, 64, 4, 2, 16, 128, 512, impl="naive")


def flash_test_config(layers: int = 2) -> LMConfig:
    """The reduced widths on the flash path, for parity tests that must
    reach the kernels' plain versions (and the reference's Pallas kernels):
    d 64, 4 heads, kv 2, head_dim 16, d_ff 128, vocab 512."""
    return _make(layers, 64, 4, 2, 16, 128, 512, impl="flash")
