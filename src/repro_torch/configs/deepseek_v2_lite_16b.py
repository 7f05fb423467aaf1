"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408 vocab=102400,
MLA kv_lora=512 (no q-lora), 2 shared + 64 routed experts top-6
[arXiv:2405.04434], about 15.71 B parameters, as
``repro/configs/deepseek_v2_lite_16b.py``. Layer 0 dense FFN d_ff=10944.
"""
import dataclasses

from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import MLAConfig
from repro_torch.nn.blocks import BlockDef, StackConfig
from repro_torch.nn.moe import MoEConfig

SKIP_SHAPES = {"long_500k": "full-attention arch (MLA-compressed cache, "
                            "full softmax): excluded per assignment rule"}


def _make(L, d, H, kv_lora, n_exp, top_k, ff_exp, ff_dense, vocab,
          impl="flash", cap=1.25):
    mla = MLAConfig(d_model=d, num_heads=H, q_lora_rank=None,
                    kv_lora_rank=kv_lora, qk_nope_dim=128, qk_rope_dim=64,
                    v_head_dim=128, impl=impl)
    moe = MoEConfig(d_model=d, num_experts=n_exp, top_k=top_k,
                    d_ff_expert=ff_exp, num_shared=2, capacity_factor=cap)
    segments = (((BlockDef("mla", "dense"),), 1),
                ((BlockDef("mla", "moe"),), L - 1))
    stack = StackConfig(segments=segments, d_model=d, d_ff=ff_dense, mla=mla,
                        moe=moe, act="silu")
    return LMConfig(name="deepseek-v2-lite-16b", family="moe",
                    vocab_size=vocab, stack=stack, tie_embeddings=False)


def config() -> LMConfig:
    return _make(27, 2048, 16, 512, 64, 6, 1408, 10944, 102400)


def reduced_config() -> LMConfig:
    m = _make(3, 64, 4, 16, 8, 2, 32, 128, 512, impl="naive", cap=2.0)
    mla = MLAConfig(d_model=64, num_heads=4, q_lora_rank=None, kv_lora_rank=16,
                    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, impl="naive")
    stack = dataclasses.replace(m.stack, mla=mla)
    return dataclasses.replace(m, stack=stack)


DRYRUN_ACCUM = {"train_4k": 2}
