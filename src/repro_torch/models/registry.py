"""Architecture registry: --arch ids -> config modules and tasks, as
``repro/models/registry.py``. The port trains and serves ``smollm-135m``
and trains ``resnet18`` and ``efficientnet_b0``; the other architectures raise
``NotImplementedError`` until the slice that brings them."""
from __future__ import annotations

import importlib
from typing import Any, List

#: ported architectures -> their config module under ``repro_torch.configs``
PORTED = {"smollm-135m": "smollm_135m", "resnet18": "resnet18",
          "efficientnet_b0": "efficientnet_b0"}

#: the reference's other architectures and the slice that ports each
PENDING = {
    "qwen2-vl-72b": "the vlm slice (frontend embeddings, multimodal RoPE)",
    "gemma3-4b": "the remaining-architectures slice (qk-norm, windows)",
    "minitron-4b": "the remaining-architectures slice",
    "stablelm-1.6b": "the remaining-architectures slice",
    "deepseek-v2-236b": "the MLA/MoE slice",
    "deepseek-v2-lite-16b": "the MLA/MoE slice",
    "mamba2-370m": "the SSM slice",
    "seamless-m4t-large-v2": "the encoder-decoder slice",
    "recurrentgemma-2b": "the RG-LRU slice",
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


def list_tasks() -> List[str]:
    """Every arch the port can run today."""
    return list(PORTED)
