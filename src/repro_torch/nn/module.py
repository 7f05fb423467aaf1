"""Parameter initializers. Params are plain tensors in nested dicts (no
wrapper, no logical-axis metadata: the port runs on one device). Random
draws come from an explicit CPU ``torch.Generator`` and move to ``device``
afterwards, so a seed gives the same weights on every device; on the
``meta`` device only shapes are made."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch import tree as tu


def param(gen: torch.Generator, shape: Sequence[int], init: str = "normal",
          scale: Optional[float] = None, device="cpu",
          dtype=torch.float32) -> torch.Tensor:
    """init: "normal" (truncated normal on [-2, 2], fan-in scaled unless
    ``scale`` is given), "zeros" or "ones"."""
    shape = tuple(int(s) for s in shape)
    dev = torch.device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    if init == "zeros":
        value = torch.zeros(shape, dtype=dtype)
    elif init == "ones":
        value = torch.ones(shape, dtype=dtype)
    elif init == "normal":
        if scale is None:
            scale = 1.0 / math.sqrt(max(1, shape[0] if shape else 1))
        value = torch.empty(shape, dtype=dtype)
        torch.nn.init.trunc_normal_(value, 0.0, 1.0, -2.0, 2.0,
                                    generator=gen)
        value = value * scale
    else:
        raise ValueError(f"unknown init {init!r}")
    return value.to(dev)


def count_params(values) -> int:
    return sum(int(x.numel()) for x in tu.leaves(values))
