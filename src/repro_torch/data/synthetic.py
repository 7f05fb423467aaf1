"""Deterministic, restartable synthetic vision data.

Every batch is a pure function of (seed, step, host_id, num_hosts): a
``torch.Generator`` on the stream's device is seeded from those alone, so a
restart resumes exactly where it left off. The construction (class-coded
stripes + hue + noise) is the reference's; the random bits are torch's, so
the port's batches differ from the reference's — parity tests feed the
reference's batches through numpy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F


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
        counter = base + step * 65536 + host_id
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 0x9E3779B97F4A7C15 + counter) % 2 ** 63)
        return gen

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
