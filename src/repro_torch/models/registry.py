"""Architecture registry: --arch ids -> config modules and tasks, as
``repro/models/registry.py``. ``ARCHITECTURES`` and ``PAPER_ARCHS`` are
the reference's lists. The port trains and serves the LMs in ``PORTED``
(dense, MoE, SSM and hybrid RG-LRU) and trains ``resnet18`` and ``efficientnet_b0``; the other
architectures raise ``NotImplementedError`` until the slice that brings
them."""
from __future__ import annotations

import importlib
from typing import Any, List

ARCHITECTURES = [
    "qwen2-vl-72b",
    "smollm-135m",
    "gemma3-4b",
    "minitron-4b",
    "stablelm-1.6b",
    "deepseek-v2-236b",
    "deepseek-v2-lite-16b",
    "mamba2-370m",
    "seamless-m4t-large-v2",
    "recurrentgemma-2b",
]

# the paper's own testbed (vision)
PAPER_ARCHS = ["resnet18", "efficientnet_b0"]

#: ported architectures -> their config module under ``repro_torch.configs``
PORTED = {"smollm-135m": "smollm_135m", "gemma3-4b": "gemma3_4b",
          "minitron-4b": "minitron_4b", "stablelm-1.6b": "stablelm_1_6b",
          "deepseek-v2-236b": "deepseek_v2_236b",
          "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
          "mamba2-370m": "mamba2_370m",
          "recurrentgemma-2b": "recurrentgemma_2b",
          "resnet18": "resnet18", "efficientnet_b0": "efficientnet_b0"}

#: the reference's other architectures and the slice that ports each
PENDING = {
    "qwen2-vl-72b": "the vlm slice (frontend embeddings, multimodal RoPE)",
    "seamless-m4t-large-v2": "the encoder-decoder slice",
}


def _module(arch: str):
    if arch in PENDING:
        raise NotImplementedError(
            f"{arch} is not ported yet: it comes with {PENDING[arch]}")
    if arch not in PORTED:
        raise KeyError(f"unknown architecture {arch!r}")
    return importlib.import_module(f"repro_torch.configs.{PORTED[arch]}")


def get_model_config(arch: str, reduced: bool = False) -> Any:
    mod = _module(arch)
    return mod.reduced_config() if reduced else mod.config()


def get_task(arch: str, reduced: bool = False, device="cuda") -> Any:
    """The task of a ported arch on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``)."""
    from repro_torch.train.task import task_for_config
    return task_for_config(get_model_config(arch, reduced), device)


def list_architectures() -> List[str]:
    return list(ARCHITECTURES)


def list_tasks() -> List[str]:
    """The archs the port can run today, in the reference's order (its
    ``ARCHITECTURES`` then ``PAPER_ARCHS``); the reference lists every
    arch, the port only those in ``PORTED``."""
    return [a for a in ARCHITECTURES + PAPER_ARCHS if a in PORTED]
