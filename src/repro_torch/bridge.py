"""Carry the reference package's state into the port.

The port keeps the reference's shapes and layouts (NHWC/HWIO, sorted-key
trees, the same slab rows), so carrying weights across is a per-leaf
``torch.from_numpy``. Inputs are nested dicts of numpy arrays, e.g. the
output of ``jax.device_get``; bf16/fp8 arrays (``ml_dtypes`` dtypes) cross
bit for bit through an integer view. This module imports no JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.core.controller import ControlState
from repro_torch.train.train_step import TrainState

_NARROW = {"bfloat16": (np.uint16, torch.bfloat16),
           "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def tensor(x, device="cpu") -> torch.Tensor:
    """One numpy array (or scalar) -> a tensor with the same bits."""
    a = np.asarray(x)
    narrow = _NARROW.get(a.dtype.name)
    if narrow is not None:
        t = torch.from_numpy(np.ascontiguousarray(a).view(narrow[0]).copy())
        return t.view(narrow[1]).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tree(t, device="cpu") -> Any:
    """Nested dicts of numpy arrays -> the same tree of tensors."""
    return tu.tree_map(lambda x: tensor(x, device), t)


def lm_params(np_tree, device="cpu") -> Any:
    """The reference's LM parameters (``split_params`` values as numpy:
    ``{"embed": {"table"}, "stack": {"seg0": {"b0": {...}}}, "final_norm":
    {"scale"}}``) -> the port's tree on ``device``. The trees have the same
    keys and shapes, stacked per-segment layer axis included, so every leaf
    crosses as it is."""
    for key in ("embed", "stack", "final_norm"):
        if key not in np_tree:
            raise ValueError(f"not an LM parameter tree: no {key!r}")
    return tree(np_tree, device)


def to_numpy(t) -> Any:
    """A tree of tensors -> the same tree of numpy arrays, bf16 as uint16
    bits (view them back with ``ml_dtypes.bfloat16``); the way caches cross
    from the port to the reference."""
    def one(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy()
        return x.numpy()
    return tu.tree_map(one, t)


def control_state(fields: Mapping[str, Any], device="cpu") -> ControlState:
    """A reference ``ControlState`` given as ``{field: array}`` (e.g.
    ``jax.device_get(ctl)._asdict()``)."""
    return ControlState(**{k: tensor(fields[k], device)
                           for k in ControlState._fields})


def train_state(params, aux_state, opt_state, control: Mapping[str, Any],
                compute: Dict[str, Any], device="cpu") -> TrainState:
    """A reference slab-resident ``TrainState`` from its fields: ``params``
    the master slab, ``opt_state`` its moment slabs, ``compute`` the
    {"slab", "p_amax"} carry, ``control`` as for ``control_state``."""
    return TrainState(tensor(params, device), tree(aux_state, device),
                      tree(opt_state, device),
                      control_state(control, device),
                      tree(compute, device))
