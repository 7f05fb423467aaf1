"""Task-level serving steps, as ``repro/train/serve.py``: greedy prefill
and single-token greedy decode over a task's serving hooks."""
from __future__ import annotations

import torch

from repro_torch.train.task import task_for_config


def as_task(task_or_cfg, device="cuda"):
    """A task as given, or a bare model config wrapped in its task on
    ``device``."""
    if hasattr(task_or_cfg, "serves_tokens"):
        return task_or_cfg
    return task_for_config(task_or_cfg, device)


def make_prefill_fn(task_or_cfg, device="cuda"):
    task = as_task(task_or_cfg, device)

    def prefill(params, batch):
        logits, caches = task.prefill(params, batch)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches
    return prefill


def make_decode_fn(task_or_cfg, device="cuda"):
    task = as_task(task_or_cfg, device)

    def decode(params, caches, token, index):
        logits, caches = task.decode(params, caches, token, index)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches
    return decode
