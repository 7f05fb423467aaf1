"""LR schedules (paper: warmup + cosine decay)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.05):
    """-> schedule(step tensor) -> f32 lr tensor on the step's device."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        one = torch.ones_like(step)
        warm = base_lr * torch.clamp_max(
            step / (one * max(warmup_steps, 1)), 1.0)
        t = torch.clamp((step - warmup_steps) /
                        (one * max(total_steps - warmup_steps, 1)), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, base_lr * cos)
    return schedule
