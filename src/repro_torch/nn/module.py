"""Parameter initializers. Params are plain tensors in nested dicts (no
wrapper, no logical-axis metadata: the port runs on one device). Random
draws come from an explicit ``torch.Generator`` on that generator's own
device (the CPU's, or the card's for a model too large to draw on one
host thread) and move to ``device`` afterwards, so a seed and a generator
device give the same weights on every device; on the ``meta`` device only
shapes are made. The reference's ``split_params``
(values apart from logical sharding axes) has nothing to split here: a
port tree is already the reference's split values tree."""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch import tree as tu


def param(gen: torch.Generator, shape: Sequence[int], init: str = "normal",
          scale: Optional[float] = None, device="cpu",
          dtype=torch.float32) -> torch.Tensor:
    """init: "normal" (truncated normal on [-2, 2], fan-in scaled unless
    ``scale`` is given), "embed" (normal times ``scale``, default 1),
    "zeros", "ones", "mamba_alog" (``log(1 + 15 U[0, 1))``: Mamba-2's
    A = -exp(A_log) over [-16, -1)) or "uniform" (LeCun-uniform,
    U[-sqrt(3 / fan_in), sqrt(3 / fan_in)), or U[-scale, scale) when
    ``scale`` is given)."""
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
        value = torch.empty(shape, dtype=dtype, device=gen.device)
        torch.nn.init.trunc_normal_(value, 0.0, 1.0, -2.0, 2.0,
                                    generator=gen)
        value = value * scale
    elif init == "embed":
        value = torch.randn(shape, dtype=dtype, generator=gen,
                            device=gen.device)
        value = value * (1.0 if scale is None else scale)
    elif init == "mamba_alog":
        u = torch.rand(shape, dtype=dtype, generator=gen, device=gen.device)
        value = torch.log(1.0 + 15.0 * u)
    elif init == "uniform":
        lim = (math.sqrt(3.0 / max(1, shape[0] if shape else 1))
               if scale is None else scale)
        u = torch.rand(shape, dtype=dtype, generator=gen, device=gen.device)
        value = -lim + 2.0 * lim * u
    else:
        raise ValueError(f"unknown init {init!r}")
    return value.to(dev)


def count_params(values) -> int:
    return sum(int(x.numel()) for x in tu.leaves(values))


def stack_init(init_fn: Callable[[torch.Generator], Any],
               gen: torch.Generator, n: int) -> Any:
    """``init_fn(gen)`` for ``n`` layers, stacked leaf by leaf: every leaf
    gains a leading layer axis, as the reference's vmapped ``stack_init``."""
    layers = [init_fn(gen) for _ in range(n)]
    return tu.tree_map(lambda *xs: torch.stack(xs), *layers)
