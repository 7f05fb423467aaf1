"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536 vocab=102400,
MLA kv_lora=512, 2 shared + 160 routed experts top-6 [arXiv:2405.04434],
as ``repro/configs/deepseek_v2_236b.py``.

Layer 0 uses a dense FFN (d_ff=12288); layers 1..59 are MoE. MLA dims:
q_lora=1536, qk_nope=128, qk_rope=64, v_head=128. Decode uses the absorbed
compressed-cache formulation (cache = c_kv(512) + k_rope(64) per position).
The full model does not fit one card: the port runs its reduced config.
"""
import dataclasses

from repro_torch.models.lm import LMConfig
from repro_torch.nn.attention import MLAConfig
from repro_torch.nn.blocks import BlockDef, StackConfig
from repro_torch.nn.moe import MoEConfig

SKIP_SHAPES = {"long_500k": "full-attention arch (MLA compresses the KV "
                            "cache but decode softmax is over all positions):"
                            " excluded per assignment rule"}


def _make(L, d, H, q_lora, kv_lora, n_exp, top_k, ff_exp, ff_dense, vocab,
          impl="flash", cap=1.25):
    mla = MLAConfig(d_model=d, num_heads=H, q_lora_rank=q_lora,
                    kv_lora_rank=kv_lora, qk_nope_dim=128, qk_rope_dim=64,
                    v_head_dim=128, impl=impl)
    moe = MoEConfig(d_model=d, num_experts=n_exp, top_k=top_k,
                    d_ff_expert=ff_exp, num_shared=2, capacity_factor=cap,
                    routed_scale=1.0)
    segments = (((BlockDef("mla", "dense"),), 1),
                ((BlockDef("mla", "moe"),), L - 1))
    stack = StackConfig(segments=segments, d_model=d, d_ff=ff_dense, mla=mla,
                        moe=moe, act="silu")
    return LMConfig(name="deepseek-v2-236b", family="moe", vocab_size=vocab,
                    stack=stack, tie_embeddings=False)


def config() -> LMConfig:
    return _make(60, 5120, 128, 1536, 512, 160, 6, 1536, 12288, 102400)


def reduced_config() -> LMConfig:
    m = _make(3, 64, 4, 32, 16, 8, 2, 32, 128, 512, impl="naive", cap=2.0)
    mla = MLAConfig(d_model=64, num_heads=4, q_lora_rank=32, kv_lora_rank=16,
                    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, impl="naive")
    stack = dataclasses.replace(m.stack, mla=mla)
    return dataclasses.replace(m, stack=stack)


DRYRUN_ACCUM = {"train_4k": 8}
