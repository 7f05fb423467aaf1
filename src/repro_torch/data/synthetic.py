"""Deterministic, restartable synthetic data: LM token tasks and vision
images.

Every batch is a pure function of (seed, step, host_id, num_hosts): a
``torch.Generator`` on the stream's device is seeded from those alone, so a
restart resumes exactly where it left off. The constructions are the
reference's (``LMTaskStream``: a noisy modular-affine next-token process
with per-sequence parameters; ``CIFARLikeStream``: class-coded stripes +
hue + noise); the random bits are torch's, so the port's batches differ
from the reference's — parity tests feed the reference's batches through
numpy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F


def _generator(device, seed: int, counter: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 0x9E3779B97F4A7C15 + counter) % 2 ** 63)
    return gen


def affine_orbit(x0, a, c, modulus: int, length: int) -> torch.Tensor:
    """x_t = (a * x_{t-1} + c) mod ``modulus`` for t < ``length``, per row
    of the (b, 1) int64 tensors x0, a, c -> (b, length). The maps f^n
    compose by squaring, so the whole orbit takes log2(length) steps of
    whole-row tensor ops instead of ``length`` tiny ones."""
    xs, A, C = x0, a, c             # invariant: (A, C) is f^n, n = len(xs)
    while xs.shape[1] < length:
        xs = torch.cat([xs, (A * xs + C) % modulus], dim=1)
        A, C = (A * A) % modulus, (A * C + C) % modulus
    return xs[:, :length]


@dataclasses.dataclass(frozen=True)
class LMTaskStream:
    """A learnable token task: each row follows x_{t+1} = (a x_t + c) mod V
    with its own a in [1, 8), c in [0, 8) and x_0, then a ``noise`` share of
    the tokens is replaced at random; labels are the tokens shifted by
    one."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05
    device: Any = "cpu"

    def batch(self, step: int, host_id: int = 0, num_hosts: int = 1):
        if self.global_batch % num_hosts:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split over {num_hosts} hosts")
        b = self.global_batch // num_hosts
        dev = torch.device(self.device)
        gen = _generator(dev, self.seed, step * 65536 + host_id)
        V = self.vocab_size
        draw = lambda lo, hi, shape: torch.randint(  # noqa: E731
            lo, hi, shape, generator=gen, device=dev, dtype=torch.int64)
        a, c, x0 = draw(1, 8, (b, 1)), draw(0, 8, (b, 1)), draw(0, V, (b, 1))
        toks = affine_orbit(x0, a, c, V, self.seq_len + 1)
        flip = torch.rand(toks.shape, generator=gen, device=dev) < self.noise
        toks = torch.where(flip, draw(0, V, toks.shape), toks).to(torch.int32)
        return {"tokens": toks[:, :-1].contiguous(),
                "labels": toks[:, 1:].contiguous()}


@dataclasses.dataclass(frozen=True)
class CIFARLikeStream:
    num_classes: int = 10
    global_batch: int = 96
    image_size: int = 32
    seed: int = 0
    train: bool = True
    device: Any = "cpu"

    def _generator(self, step: int, host_id: int) -> torch.Generator:
        base = 0 if self.train else 10_000_000
        return _generator(self.device, self.seed,
                          base + step * 65536 + host_id)

    def batch(self, step: int, host_id: int = 0, num_hosts: int = 1):
        if self.global_batch % num_hosts:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split over {num_hosts} hosts")
        b = self.global_batch // num_hosts
        dev = torch.device(self.device)
        gen = self._generator(step, host_id)
        y = torch.randint(0, self.num_classes, (b,), generator=gen,
                          device=dev)
        S = self.image_size
        xs = torch.arange(S, device=dev)
        xx, yy = torch.meshgrid(xs, xs, indexing="xy")
        # class-conditional structure: stripe frequency + orientation + hue
        freq = (y % 5 + 1).float()[:, None, None]
        orient = (y // 5)[:, None, None]
        phase = torch.rand((b, 1, 1), generator=gen, device=dev) * 2 * math.pi
        grid = torch.where(orient == 0, xx[None], yy[None]).float()
        base_img = torch.sin(grid * freq * 2 * math.pi / S + phase)
        hue = F.one_hot(y % 3, 3).float()[:, None, None, :]
        img = base_img[..., None] * (0.5 + hue)
        img = img + 0.65 * torch.randn((b, S, S, 3), generator=gen,
                                       device=dev)
        return {"images": img.float(), "labels": y.to(torch.int32)}
