"""Deterministic fault injection, as the reference's
``repro.resilience.faults``.

A ``FaultPlan`` is a seeded schedule of named faults threaded through the
dispatch seams: the trainer's step loop, the checkpoint writer and the
serving session's admit and decode. Each
fault names a SITE (where in the pipeline it fires), a first eligible
STEP, and a ``repeats`` budget; ``FaultPlan.fires`` is the single gate
every seam calls. A trainer with no plan armed pays one ``is None`` check
per seam.

Fault sites (the names and semantics of the reference's):

    train.step_oom    an out-of-memory error raised at step dispatch:
                      ``torch.OutOfMemoryError``, the type the CUDA caching
                      allocator raises, so injected and real OOMs take one
                      recovery path
    train.nonfinite   non-finite burst: the carried loss scale is forced to
                      inf for ``repeats`` consecutive steps, so every
                      gradient in the burst overflows through the real
                      finite gate (update skipped, grads_finite=0)
    train.sigterm     SIGTERM delivered to the process at step k (spot
                      reclamation; runs the preemption handler chain)
    ckpt.corrupt      storage damage applied to the newest COMMITTED
                      generation right after its save (torn leaf, dropped
                      manifest entry, or stale marker over a deleted dir)
    serve.step_oom    an OOM at a serve dispatch (admit or decode)
    serve.latency     a decode-step latency spike of ``seconds``, added to
                      the step's recorded time

``FaultPlan.rng`` is numpy's ``default_rng(seed)``, as the reference's, so
both packages pick the same corruption victims.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import traceback
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

FAULT_SITES = ("train.step_oom", "train.nonfinite", "train.sigterm",
               "ckpt.corrupt", "serve.step_oom", "serve.latency")

CORRUPTION_KINDS = ("truncate_leaf", "drop_manifest", "stale_marker")


def simulated_oom(site: str, step: int, detail: Any = None) -> Exception:
    """A constructed out-of-memory error of the type a real allocator
    failure raises (``torch.OutOfMemoryError``), so every recovery path
    tested against injections handles the genuine article identically."""
    return torch.OutOfMemoryError(
        f"CUDA out of memory (injected: site={site} step={step} "
        f"detail={detail})")


def is_oom_error(e: BaseException) -> bool:
    """Memory exhaustion, injected or real: ``torch.OutOfMemoryError``, or
    an error whose message says so (XLA's RESOURCE_EXHAUSTED, or 'out of
    memory' in prose), as the reference tests."""
    if isinstance(e, torch.OutOfMemoryError):
        return True
    msg = str(e)
    return "RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower()


def release_failed_attempt(e: BaseException, device) -> None:
    """Free what a dispatch that failed with ``e`` still holds before
    recovery allocates: the locals of the frames its traceback holds (the
    attempt's activations), then, on a card, the blocks the caching
    allocator kept from it. The retry then allocates from an empty cache,
    as a fresh run does. In a cache that the failed attempt fragmented, a
    convolution's workspace can fail under a memory cap, and cuDNN then
    runs another algorithm and keeps it for that shape for the rest of the
    process: the retry, and every later step, would round differently."""
    traceback.clear_frames(e.__traceback__)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@dataclasses.dataclass
class Fault:
    """One scheduled fault. ``repeats`` bounds how many times it fires
    (None = unlimited, e.g. a persistently too big rung); ``rung``/``tier``
    restrict OOM sites to one rung or tier; ``kind`` picks the ckpt.corrupt
    flavor; ``seconds`` sizes a serve.latency spike."""

    site: str
    step: int = 0
    repeats: Optional[int] = 1
    rung: Optional[int] = None
    tier: Optional[int] = None
    kind: str = "truncate_leaf"
    seconds: float = 0.0
    fired: int = 0               # mutable: firings so far

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(expected one of {FAULT_SITES})")
        if self.site == "ckpt.corrupt" and self.kind not in CORRUPTION_KINDS:
            raise ValueError(f"unknown corruption kind {self.kind!r} "
                             f"(expected one of {CORRUPTION_KINDS})")


class FaultPlan:
    """A seeded, deterministic fault schedule: two plans built with the
    same faults and seed fire identically, so every recovery trajectory a
    plan provokes can be compared with an oracle's."""

    def __init__(self, faults, seed: int = 0):
        self.faults: List[Fault] = list(faults)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        #: audit trail of every firing: (site, step, detail)
        self.log: List[Tuple[str, int, Any]] = []

    def fires(self, site: str, step: int, rung: Optional[int] = None,
              tier: Optional[int] = None) -> Optional[Fault]:
        """The fault scheduled at ``site`` for ``step`` (consuming one
        firing from its budget), or None. ``rung``/``tier`` must match the
        fault's restriction when both sides specify one."""
        for f in self.faults:
            if f.site != site:
                continue
            if f.repeats is not None and f.fired >= f.repeats:
                continue
            if step < f.step:
                continue
            if f.rung is not None and rung is not None and f.rung != rung:
                continue
            if f.tier is not None and tier is not None and f.tier != tier:
                continue
            f.fired += 1
            self.log.append((site, int(step),
                             {"rung": rung, "tier": tier, "kind": f.kind}))
            return f
        return None


def corrupt_checkpoint(directory: str, kind: str = "truncate_leaf",
                       rng: Optional[np.random.Generator] = None,
                       step: Optional[int] = None) -> str:
    """Deterministically damage a COMMITTED generation (the newest by
    default), the ckpt.corrupt fault's storage model:

        truncate_leaf   a leaf .npy loses its second half (the torn write
                        an fsync-less writer would leave behind)
        drop_manifest   one manifest entry vanishes (partial manifest
                        rewrite) while its leaf file stays on disk
        stale_marker    the generation directory is deleted under its
                        .COMMITTED marker (marker durable, data lost)

    The victim is drawn from ``rng`` as the reference draws it. Returns a
    description of what was damaged."""
    from repro_torch.checkpoint.checkpoint import latest_step
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:012d}")
    if kind == "stale_marker":
        shutil.rmtree(d)
        return f"step {step}: directory deleted under its COMMITTED marker"
    if kind == "truncate_leaf":
        files = sorted(fn for fn in os.listdir(d) if fn.endswith(".npy"))
        fn = files[int(rng.integers(len(files)))] if rng is not None \
            else files[0]
        p = os.path.join(d, fn)
        size = os.path.getsize(p)
        with open(p, "r+b") as f:
            f.truncate(max(size // 2, 1))
        return f"step {step}: {fn} truncated {size} -> {max(size // 2, 1)}B"
    if kind == "drop_manifest":
        mp = os.path.join(d, "manifest.json")
        with open(mp) as f:
            doc = json.load(f)
        keys = sorted(doc["leaves"].keys())
        victim = keys[int(rng.integers(len(keys)))] if rng is not None \
            else keys[0]
        del doc["leaves"][victim]
        with open(mp, "w") as f:
            json.dump(doc, f, indent=1)
        return f"step {step}: manifest entry {victim!r} dropped"
    raise ValueError(f"unknown corruption kind {kind!r}")
