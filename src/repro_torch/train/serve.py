"""Task-level serving steps, as ``repro/train/serve.py``: greedy prefill,
single-token greedy decode and cache-free batched inference over a task's
serving hooks."""
from __future__ import annotations

import torch

from repro_torch.train.task import TrainTask, task_for_config


def as_task(task_or_cfg, device="cuda") -> TrainTask:
    """A task as given, or a bare model config wrapped in its task on
    ``device``."""
    if isinstance(task_or_cfg, TrainTask):
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


def make_infer_fn(task_or_cfg, device="cuda"):
    task = as_task(task_or_cfg, device)

    def infer(params, aux_state, batch):
        logits = task.infer(params, aux_state, batch)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits
    return infer
