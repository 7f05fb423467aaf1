"""resnet18 [paper]: the paper's primary testbed (CIFAR-10/100), as
``repro/configs/resnet18.py``."""
from repro_torch.models.vision import VisionConfig


def config() -> VisionConfig:
    return VisionConfig(name="resnet18", num_classes=10, stem_stride=1)


def reduced_config() -> VisionConfig:
    return config()  # already CIFAR-scale
