#!/usr/bin/env python3
"""Seconds of the seeded weight draw on this host's CPU, the draw every
``task.init`` makes on a CPU generator before the weights move to the card.

    python3 chip_init_draw.py [--elems N] [--arch stablelm-1.6b]

Times two ways to draw a truncated normal on [-2, 2] into N f32 elements
(default 50 M), three times each: ``torch.nn.init.trunc_normal_``, the
port's draw (some torch versions draw it in one pass by inverse CDF,
others redraw the whole tensor until no element lies outside the
bounds), and one pass by inverse CDF written out (``uniform_`` between
the bounds' CDFs, then ``erfinv_``: the method of
``jax.random.truncated_normal``).
Then the seconds of ``lm_init`` for ``--arch`` on the CPU with the port's
``nn.module.param`` as it stands, its parameter count, and the seconds a
model of each dense GQA architecture would take at the measured rate of
each draw (parameter counts from ``lm_init`` on the ``meta`` device).
Prints the host's torch version and CPU count first; needs no card.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))


def trunc_normal_reject(x, gen):
    return torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)


def trunc_normal_icdf(x, gen):
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    return x.uniform_(lo, hi, generator=gen).erfinv_().mul_(math.sqrt(2.0))


def best_of(fn, n, reps=3):
    out = []
    for r in range(reps):
        x = torch.empty(n)
        gen = torch.Generator().manual_seed(r)
        t = time.perf_counter()
        fn(x, gen)
        out.append(time.perf_counter() - t)
    return min(out), out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--elems", type=int, default=50_000_000)
    ap.add_argument("--arch", default="stablelm-1.6b")
    args = ap.parse_args()
    from repro_torch.models.lm import lm_init
    from repro_torch.models.registry import get_model_config
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"{os.cpu_count()} CPUs, {torch.get_num_threads()} torch threads",
          flush=True)
    rates = {}
    for name, fn in (("trunc_normal_", trunc_normal_reject),
                     ("inverse CDF", trunc_normal_icdf)):
        best, all_s = best_of(fn, args.elems)
        rates[name] = best / args.elems
        print(f"{name}: {args.elems} elements in "
              f"{', '.join(f'{s:.3f}' for s in all_s)} s", flush=True)
    for arch in ("stablelm-1.6b", "minitron-4b", "gemma3-4b"):
        n = sum(t.numel() for t in _leaves(lm_init(
            None, get_model_config(arch), device="meta")))
        print(f"{arch}: {n} parameters; at these rates "
              + ", ".join(f"{k} {r * n:.1f} s" for k, r in rates.items()),
              flush=True)
    t = time.perf_counter()
    params = lm_init(torch.Generator().manual_seed(0),
                     get_model_config(args.arch), device="cpu")
    n = sum(t.numel() for t in _leaves(params))
    print(f"lm_init({args.arch}) on the CPU: {time.perf_counter() - t:.1f} s "
          f"for {n} parameters", flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
