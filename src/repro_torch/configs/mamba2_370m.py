"""mamba2-370m [ssm]: 48L d_model=1024, attention-free, vocab=50280, SSD
state 128 [arXiv:2405.21060], 368,338,432 parameters with tied
embeddings, as ``repro/configs/mamba2_370m.py``: head_dim 64, expand 2
(d_inner 2048, 32 heads), conv width 4, chunk 256. No attention kernel
runs on this model; its decode state is O(1) in the context.
"""
from repro_torch.models.lm import LMConfig
from repro_torch.nn.blocks import BlockDef, StackConfig
from repro_torch.nn.ssm import SSMConfig

SKIP_SHAPES = {}


def _make(L, d, state, hd, vocab, chunk=256):
    ssm = SSMConfig(d_model=d, state_dim=state, head_dim=hd, expand=2,
                    n_groups=1, conv_width=4, chunk=chunk)
    stack = StackConfig(segments=(((BlockDef("ssd", "none"),), L),),
                        d_model=d, d_ff=0, ssm=ssm)
    return LMConfig(name="mamba2-370m", family="ssm", vocab_size=vocab,
                    stack=stack, tie_embeddings=True)


def config() -> LMConfig:
    return _make(48, 1024, 128, 64, 50280)


def reduced_config() -> LMConfig:
    return _make(3, 64, 16, 16, 512, chunk=8)
