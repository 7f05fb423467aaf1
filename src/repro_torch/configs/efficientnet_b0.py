"""efficientnet_b0 [paper]: the paper's second testbed (CIFAR-10/100), as
``repro/configs/efficientnet_b0.py``.

The paper resizes CIFAR to 224x224 for pretrained-input parity; training
from scratch keeps 32x32 with a stride-1 stem (standard CIFAR adaptation).
"""
from repro_torch.models.vision import VisionConfig

# the reference's sequence-shaped LM cells do not apply to a vision model
SKIP_SHAPES = {s: "vision model: LM sequence shapes not applicable"
               for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")}


def config() -> VisionConfig:
    return VisionConfig(name="efficientnet_b0", num_classes=10, stem_stride=1)


def reduced_config() -> VisionConfig:
    return config()
