#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # from the repository root

Phases (any failure raises and the script exits non-zero):

  1. the card (``nvidia-smi``), torch and CUDA versions;
  2. build every CUDA source under ``src/repro_torch/kernels/csrc`` with
     ``nvcc`` (all sources at once), print the seconds and the ptxas report
     (for the flash forward and backward sources, each instantiation's
     registers and spills; none may spill in the wgmma sources, *_sm90);
  3. hold each kernel against its plain PyTorch version on the card, time
     both with CUDA events, compute the least time the card could take
     (``bound_ms``) and time one PyTorch call computing the same function
     where there is one (``library_ms``):
       - fused_stats / fused_apply at the ResNet-18 slab shape (22,016 x
         512, 11 layers, f32), at EfficientNet-B0's (7,936 x 512, 21
         layers, f32), at the LM training slab (smollm-135m's 134.5 M
         parameters under ``lm_grouping``, 32 layers, the bf16 gradient
         and copy of that path) and over every fused_apply variant,
         bitwise;
       - qdq_cast, both forms (two-pass: the absmax found in the call;
         one-pass: given), over every variant and edge case (offsets 0-7
         elements, sizes 0-17 and 1,048,579, f32/bf16 in and out, NaN
         and inf, ten repeats) and over all of smollm-135m's leaves (the
         serving path's tier-0 cast), bitwise; each form one device
         operation a call; timed f32 and bf16 out, beside the cast then
         ``.to(bf16)`` and a copy;
       - flash_attention, both routes (``flash_attention.fwd_route``): the
         tensor-core kernel (bf16) over every variant (causal, not causal,
         window, segments; GQA rep 1 and 3; (D, Dv) in (16, 16), (64, 64),
         (128, 128), (192, 192), (256, 256), (192, 128)) and at the main
         paths' shapes (B 1, 2, 4, 8, S 1024, 9/3 heads, head_dim 64, with
         the LSE); the SIMT kernel (f32 at head dims 16 and 64, bf16 at 24
         and 40, which its route takes) over every variant at the test
         shapes; both timed at the serving
         prefill's shape (B 1, S 1024) beside SDPA, the SIMT kernel also
         in f32, its route's type;
       - flash_decode (the split-key kernel, a cluster of
         ``DECODE_CLUSTER`` blocks a row and kv head) over ragged lengths
         (0, 1, L, between, and the split's edges), head dims (16, 64,
         (64, 32), (256, 256), (20, 36)), rep 1 and rep * Dv 2048, B 1, 2,
         4 at L 2048, f32 and bf16, and at the main path's decode (4 rows
         against a 2048-slot cache; a bitwise repeat; cluster sizes 4, 8,
         16 timed, log only);
       - delta over Dv 16, 36, 40, 64, 128, 256 (f32 and bf16) and at the
         LM rungs, each call repeated bitwise;
       - the three flash backward kernels (delta, dQ, dK/dV), all three
         routes (``flash_attention.bwd_route``: bf16 takes the tensor-core
         dQ and dK/dV, f32 the split-TF32 ones, bf16 at head dims 24/64
         and 64/40 the SIMT ones; every f32 variant also runs the SIMT
         kernels through their raw entry) over every variant, at the wide
         head dims (192, 192), (256, 256), (192, 128) (the SIMT and
         split-TF32 kernels on 32-row tiles; every mask, f32 and bf16; the
         bf16 routes timed at head dim 256, B 1, S 1024 beside SDPA, log
         only), and with the forward kernel (LSE output on) at the LM
         training shapes (B 2, 4 and 8, S 1024, 9/3 heads, head_dim 64,
         bf16, causal), timed at B 8 against the forward and the backward
         of ``scaled_dot_product_attention`` (the forward's SIMT kernel,
         and the SIMT dQ and dK/dV on the same bf16 inputs, beside them;
         then in f32 the split-TF32 and the SIMT dQ and dK/dV in turns,
         beside SDPA's f32 backward); the differentiable
         ``ops.flash_attention`` against autograd through the plain
         forward in f32 and in bf16, head dim 256 included, its launches
         counted by route (the f32 backwards' split-TF32 launches go into
         the ``_tf32`` rows as ``f32_function_launches``);
       - grad_stats over the reference's test shapes (f32, bf16), its
         benchmark's (1024, 1024) and its registry's (1,000,000,) f32, an
         empty tensor and tensors holding NaN, +inf, -inf; absmax bitwise,
         sums within 2^-20 of the sum of |terms| of an f64 sum, two
         launches bitwise equal; timed at (1024, 1024) f32;
  4. correctness of whole steps: one slab-resident train step of each of
     ResNet-18 and EfficientNet-B0 at batch 4, one §3.2 ``hutchinson``
     refresh of EfficientNet-B0 (b_curv 4, the same probe), one prefill
     plus 4 teacher-forced decode steps of smollm-135m at full width and 2
     layers, and one slab-resident LM train step of smollm-135m at full
     width and 2 layers (S 1024, B 2), and one reference step (tree-form,
     unfused) of each of ResNet-18 and EfficientNet-B0 at batch 2 and
     smollm-135m at 2 layers, each on the card against the same on the
     CPU (plain versions), from the same weights;
  5. the main paths, with the kernels' launch counts read around each:
       - ``run_method("triaccel", "resnet18", steps=50, batch0=32)`` and
         the same for ``"efficientnet_b0"`` (``EFF_STEPS``); then a
         ``Trainer`` of EfficientNet-B0 with ``TriAccelConfig()``'s
         default ``hutchinson`` curvature (``t_curv`` lowered to 5) for 6
         steps, whose refresh must set a finite, non-zero curvature;
       - serving: ``ServeSession`` over smollm-135m at full width (30
         layers), prompt 1024, cache 2048, rungs 1/2/4, tiers 1 then 0,
         eight requests of 64 tokens in two waves; the launch counts must
         equal 30 x prefills (flash_attention, every one on the
         tensor-core route), 30 x decode steps (flash_decode) and the
         tier-0 leaves (qdq_cast, two-pass), and no attention gate may
         fall back;
       - LM training: ``repro_torch.launch.train.main`` for smollm-135m at
         30 layers, S 1024, rungs 2/4/8, 20 steps (``LM_TRAIN_ARGS``,
         t_ctrl / t_curv lowered to 5 / 10 so both controls fire); the
         counts must equal 2 x 30 forward launches (forward and remat
         recompute, all on the tensor-core route) and 30 of each backward
         kernel a step (dQ and dK/dV all on the tensor-core route); then
         the tier-0 serving set of the trained masters from
         ``Trainer.serving_amax_tree`` (qdq_cast, one-pass, one launch a
         leaf, bitwise against the plain version);
  6. where the time goes: ``torch.profiler`` over a few ResNet-18 and
     EfficientNet-B0 train steps (Tri-Accel and FP32), over one serving
     step that admits four prompts (the prefill),
     over a few decode steps at rung 4 and over one LM train step at rung
     8; the LM step time per rung;
  7. the reference step's main paths, with the launch counts read around
     each: ``run_method("fp32", "resnet18" | "efficientnet_b0", steps=20,
     batch0=32)`` (no fused-update launch, codes reported fp32, the rung
     fixed at 32; EfficientNet-B0's step time and peak printed beside its
     Tri-Accel ones and the paper's 0.301 GB FP32 point) and
     ``launch.train.main`` with ``--no-triaccel`` for smollm-135m at 30
     layers, S 1024, rung 8, 10 steps (2 x 30 forward, on the tensor-core
     route, and 30 of each backward kernel a step, dQ and dK/dV on the
     tensor-core route, no fused update); then
     grad_stats' path, its
     public op over every leaf of each path's reference-step gradient
     tree (f32, after the loss-scale division), counted around those calls
     and held against the plain version, timed on the largest leaf
     (smollm-135m's (49152, 576) embedding) and, for EfficientNet-B0,
     over all 181 leaves in turn;
  8. checkpoint, resume and preemption (``repro_torch.checkpoint``, the
     reference's on-disk format): the Tri-Accel ResNet-18 trainer with a
     checkpoint directory for 20 steps (a generation every 10, 2 kept);
     a fresh trainer restores on the card bitwise (every slab, padding
     included, the control and BatchNorm state, the serving absmax table),
     and a CPU trainer too; both card trainers take 5 more steps (the
     restored one launching fused_stats and fused_apply once a step) and
     their losses agree (bitwise where the card's step is deterministic,
     else within rtol 1e-3); the keep-2 collection; a CPU-written
     generation restored on the card bitwise. Then smollm-135m through
     ``launch.train.main(LM_TRAIN_ARGS + ["--ckpt", dir])``: SIGTERM in
     step 9 makes the first call checkpoint and exit with 143, the same
     call again prints ``resumed at step 10`` and takes the last 10 steps
     (the flash forward, its three backward kernels and the fused update
     counted around it). For each model: the bytes of one generation, the
     host stall of ``save()``, the background write and ``maybe_restore``
     on the card, printed beside the card's name and power limit. The
     checkpoints go to a temporary directory that the phase removes.

A kernel that runs on several main paths at different shapes
(fused_stats and fused_apply: ResNet-18, EfficientNet-B0 and LM training;
flash_attention: serving and LM training; grad_stats: the gradient trees
of ResNet-18, EfficientNet-B0 and smollm-135m) has a row for each in the
``kernels`` line, the others named ``<kernel>@efficientnet_b0``,
``<kernel>@lm_train``, ``grad_stats@efficientnet_b0_reference`` and
``grad_stats@lm_reference``: its launches on that path beside its time at
that path's shape (``grad_stats@efficientnet_b0_reference``: one pass over
the 181 leaves, 181 launches). The reference paths make no
grad_stats launch themselves, as in the reference. The flash forward's
rows carry ``fwd_route``: ``flash_attention`` and
``flash_attention@lm_train`` are the tensor-core kernel, which the main
paths run; ``flash_attention_simt`` is the SIMT kernel f32 callers get (no
main path launches it), timed in f32. The backward's dQ and dK/dV rows
carry ``bwd_route`` the same way: ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv`` are the tensor-core kernels the LM paths run;
``flash_attention_bwd_dq_tf32`` and ``flash_attention_bwd_dkv_tf32`` the
split-TF32 kernels of f32 callers (no main path launches them; their
``f32_function_launches`` come from the f32 autograd check), timed in f32
with the TF32 bound (``f32_fma_bound_ms`` beside it);
``flash_attention_bwd_dq_simt`` and ``flash_attention_bwd_dkv_simt`` the
SIMT kernels (bf16 head dims the tensor-core kernels refuse), timed in
f32 as before. ``qdq_cast`` is the two-pass
form the serving path launches, ``qdq_cast_one_pass`` the one-pass form
the LM path's tier-0 set launches, both timed over the 11 leaves, f32 in
and bf16 out as those paths cast (``f32_out_*``: the same with f32 out).
The ``flash_decode``, ``flash_attention_bwd_delta``, both ``qdq_cast``,
every ``fused_stats`` and ``fused_apply`` and the
``grad_stats@efficientnet_b0_reference`` rows also carry ``device_ms``, the
kernel's device time from the profiler
(``flash_decode`` also SDPA's, ``library_device_ms``): their ``ms``, from
CUDA events over back-to-back launches, can include the card's waits for
the host's launches.

The last three lines are the ``kernels`` JSON line, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a card (or
outside a checkout of the repository) it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import math
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CSRC = "src/repro_torch/kernels/csrc"
# (name, CUDA source, the Pallas call it replaces)
KERNELS = {
    "fused_stats": (f"{CSRC}/fused_update.cu",
                    "src/repro/kernels/fused_update.py:122"),
    "fused_apply": (f"{CSRC}/fused_update.cu",
                    "src/repro/kernels/fused_update.py:317"),
    "qdq_cast": (f"{CSRC}/qdq_cast.cu",
                 "src/repro/kernels/qdq_cast.py:98"),
    "qdq_cast_one_pass": (f"{CSRC}/qdq_cast.cu",
                          "src/repro/kernels/qdq_cast.py:116"),
    "flash_attention": (f"{CSRC}/flash_fwd_sm90.cu",
                        "src/repro/kernels/flash_attention.py:222"),
    "flash_attention_simt": (f"{CSRC}/flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:222"),
    "flash_attention_bwd_delta": (
        f"{CSRC}/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:379"),
    "flash_attention_bwd_dq": (f"{CSRC}/flash_bwd_sm90.cu",
                               "src/repro/kernels/flash_attention.py:405"),
    "flash_attention_bwd_dq_tf32": (
        f"{CSRC}/flash_bwd_tf32.cu",
        "src/repro/kernels/flash_attention.py:405"),
    "flash_attention_bwd_dq_simt": (
        f"{CSRC}/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:405"),
    "flash_attention_bwd_dkv": (f"{CSRC}/flash_bwd_sm90.cu",
                                "src/repro/kernels/flash_attention.py:441"),
    "flash_attention_bwd_dkv_tf32": (
        f"{CSRC}/flash_bwd_tf32.cu",
        "src/repro/kernels/flash_attention.py:441"),
    "flash_attention_bwd_dkv_simt": (
        f"{CSRC}/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:441"),
    "flash_decode": (f"{CSRC}/flash_decode_sm90.cu",
                     "src/repro/kernels/flash_attention.py:546"),
    "grad_stats": (f"{CSRC}/grad_stats.cu",
                   "src/repro/kernels/grad_stats.py:52"),
}
# the LM training main path (phase 5c): launcher arguments and the rung
# controller / fisher refresh periods, lowered from the launcher's 20 / 100
# so both fire within the run
LM_TRAIN_ARGS = ["--arch", "smollm-135m", "--seq", "1024", "--rungs",
                 "2,4,8", "--steps", "20", "--ladder", "gpu"]
LM_T_CTRL, LM_T_CURV = 5, 10
# the EfficientNet-B0 Tri-Accel main path's steps (phase 5; ``--batch0``
# its rung, as ResNet-18's)
EFF_STEPS = 50
# published peaks of the H100 SXM (NVIDIA's data sheet): device memory
# bytes/s, f32 operations/s outside the tensor cores, bf16 tensor-core
# operations/s (dense) and TF32 tensor-core operations/s (dense)
PEAKS = {"H100": (3.35e12, 67e12, 989e12, 495e12)}


def log(*a):
    print(*a, flush=True)


def check(ok, what) -> None:
    """Fail the run (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def signals_kept():
    """Put back the SIGTERM and SIGINT handlers after a call that installs
    the launcher's preemption handler (which chains neither SIG_DFL nor
    Python's SIGINT handler): this script must stay killable."""
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield
    finally:
        for s, h in prev.items():
            signal.signal(s, h)


def ptxas_kernels(text: str):
    """-> [(kernel, registers, bytes of spill stores)] from an nvcc -Xptxas
    -v log, names demangled with the toolkit's cu++filt where it has one."""
    out, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    filt = Path("/usr/local/cuda/bin/cu++filt")
    if out and filt.exists():
        names = subprocess.run(
            [str(filt)], input="\n".join(n for n, _, _ in out),
            capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(names) == len(out):
            out = [(re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::",
                           "", re.sub(r"\(.*", "", d.replace("(int)", ""))),
                    r, sp) for d, (_, r, sp) in zip(names, out)]
    return out


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no published peaks for {name!r}")


def bound(nbytes: float, nops: float, bw: float, ops_rate: float):
    """-> (least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / bw, nops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------- timing ---
def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean device time of ``iters`` back-to-
    back calls, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return statistics.median(out)


def device_ms(fn, iters: int = 50) -> float:
    """Device time of one ``fn()`` call: the summed durations of the
    kernels (and copies) that ``torch.profiler`` records on the card over
    ``iters`` calls, after a warm-up, over ``iters``. Unlike ``time_ms``
    it leaves out the gaps where the card waits for the host's launches,
    which a kernel of a few microseconds can be shorter than."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):      # a trace that came back empty is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start
                 for e in prof.events() if e.device_type == cuda)
        if us > 0:
            return us / iters / 1e3
    raise RuntimeError("check failed: the profiler recorded no device time")


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal after widening to f32, NaN equal to NaN (the NaN
    payload of a cast is not part of the contract)."""
    a, b = a.float(), b.float()
    nan = torch.isnan(a) & torch.isnan(b)
    bits = a.view(torch.int32) == b.view(torch.int32)
    return bool((bits | nan).all())


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    both = (torch.isnan(a) & torch.isnan(b)) | (a == b)
    d = torch.where(both, torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max())


# ------------------------------------------------ phase 3: the kernels ---
def vision_view(arch: str = "resnet18"):
    """The slab view of a vision testbed's parameters (ResNet-18: 22,016
    rows, 11 layers; EfficientNet-B0: 7,936 rows, 21 layers)."""
    from repro_torch.core.grouping import flat_grouping
    from repro_torch.kernels.layout import slab_view
    from repro_torch.models.vision import VisionConfig, vision_init
    params, _ = vision_init(torch.Generator(), VisionConfig(arch),
                            device="meta")
    return slab_view(params, flat_grouping(params))


def lm_train_view():
    """The slab view of smollm-135m's parameters under ``lm_grouping``
    (30 layers + embed + head), as the LM training path builds it."""
    from repro_torch.configs import smollm_135m
    from repro_torch.kernels.layout import slab_view
    from repro_torch.train.task import LMTask
    task = LMTask(smollm_135m.config(), device="cpu")
    params, _ = task.init(torch.Generator(), device="meta")
    return slab_view(params, task.grouping(params))


def lm_train_variant():
    """The fused update's variant on the LM training path: the launcher's
    default optimizer (the trainer's sgdm defaults), the gradient slab and
    compute copy in the LM's compute dtype; ``lm_train_main_path`` asserts
    that its trainer ran exactly this."""
    from repro_torch.configs import smollm_135m
    from repro_torch.optim.optimizers import sgdm
    from repro_torch.train.trainer import TrainerConfig
    tc = TrainerConfig()
    cd = smollm_135m.config().compute_dtype
    return dict(spec=sgdm(tc.momentum, tc.weight_decay).spec, g_dtype=cd,
                cp_dtype=cd, ladder=LM_TRAIN_ARGS[
                    LM_TRAIN_ARGS.index("--ladder") + 1], sr=False)


def check_stats(view, dev, bw, f32_ops, g_dtype=torch.float32,
                what="ResNet-18"):
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ops
    rows, L = view.rows, view.num_layers
    gen = torch.Generator(device=dev).manual_seed(1)
    # at least three gradient slabs and 120 MB (ResNet-18: three, 135 MB;
    # EfficientNet-B0: eight of 16 MB), so each timed launch finds its
    # input out of the 50 MB L2 cache, as after a backward
    nbuf = max(3, -(-120_000_000 // (rows * 512 * torch.finfo(g_dtype).bits
                                     // 8)))
    gs = [(torch.randn((rows, 512), generator=gen, device=dev) * 1e-3
           ).to(g_dtype) for _ in range(nbuf)]
    g = gs[0]
    g[5, 7], g[300, 0], g[301, 511] = float("inf"), -float("inf"), float("nan")
    g[min(9000, rows - 7), 100:110] = float("nan")
    rl = view.row_blocks(dev)
    got = ops.fused_stats(g, rl, L)
    want = fu.fused_stats_ref(g, rl, L)
    torch.cuda.synchronize()
    names = ("sum", "sum_sq", "absmax", "nonfinite")
    for n, a, b in zip(names, got, want):
        if n in ("absmax", "nonfinite"):
            check(same(a, b), f"fused_stats {n}: {a} vs {b}")
        elif n == "sum_sq":  # another order of non-negative terms: rtol 1e-5
            check(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
                  f"fused_stats {n}: {a} vs {b}")
    # A layer's sum of random-signed gradients cancels: a layer of ~1e6
    # terms of 1e-3 sums to O(1) or less while any f32 summation order is
    # off by O(1e-7) of the summed magnitudes. So each f32 sum (the kernel's
    # and the plain version's) is held to an f64 sum of the same finite
    # lanes within 2^-20 of the layer's sum of |g|, the conditioning of the
    # sum, not of its (possibly near-zero) value.
    fin = torch.where(torch.isfinite(g), g, 0.0).double()
    ids = rl.reshape(-1).long()
    truth = torch.zeros(L, dtype=torch.float64, device=dev).index_add_(
        0, ids, fin.sum(dim=1))
    mass = torch.zeros(L, dtype=torch.float64, device=dev).index_add_(
        0, ids, fin.abs().sum(dim=1))
    for who, v in (("kernel", got[0]), ("plain", want[0])):
        off = (v.double() - truth).abs()
        check(bool((off <= 2.0 ** -20 * mass).all()),
              f"fused_stats sum ({who}): off the f64 sum by "
              f"{off.tolist()} against sum|g| {mass.tolist()}")
    log(f"fused_stats ({what}) sum: kernel and plain off the f64 sum by "
        f"at most "
        f"{float((got[0].double() - truth).abs().max()):.3g} / "
        f"{float((want[0].double() - truth).abs().max()):.3g} (sum|g| per "
        f"layer {float(mass.min()):.3g}..{float(mass.max()):.3g}); kernel vs "
        f"plain {float((got[0] - want[0]).abs().max()):.3g}")
    check(float(got[3].sum()) == 13.0, "fused_stats counts 13 non-finite")
    err = max(abs_err(a, b) for a, b in zip(got, want))
    lib = fu._lib()
    part = torch.empty((rows // lib.tri_rows_per_block()) * L * 4,
                       device=dev)
    out = torch.empty((4, L), device=dev)
    k = [0]

    def raw():          # the kernel alone: no checks, no allocation
        k[0] = (k[0] + 1) % nbuf
        lib.tri_fused_stats(gs[k[0]].data_ptr(), fu._DTYPE_CODE[g_dtype],
                            rl.data_ptr(), rows, L, part.data_ptr(),
                            out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)

    ms = time_ms(raw, iters=30)
    dev_ms = device_ms(raw)
    plain_ms = time_ms(lambda: fu.fused_stats_ref(g, rl, L), iters=5)
    nbytes = rows * 512 * g.element_size() + rows * 4 + 4 * L * 4
    nops = rows * 512 * 8      # isfinite, select, add, mul+add, add, abs+max
    b_ms, by = bound(nbytes, nops, bw, f32_ops)
    log(f"fused_stats ({what}) {rows}x512 {g_dtype} L={L}: kernel {ms:.4f} "
        f"ms (device {dev_ms:.4f} ms, both kernels), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), max|err| {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None}


def _apply_inputs(rows, L, dev, adam, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda: torch.randn((rows, 512), generator=gen, device=dev)
    g, p, m = r(), r() * 2.0, r() * 0.1
    v = r().abs() * 0.01 if adam else None
    meta = (rows // 256, 256)
    ids = torch.randint(0, L, meta, generator=gen, device=dev,
                        dtype=torch.int32)
    lr = torch.full(meta, 1e-2, device=dev)
    lr.view(-1)[::7] = 0.0
    code = torch.randint(0, 3, meta, generator=gen, device=dev,
                         dtype=torch.int32)
    qs = 448.0 / (1.0 + 7.0 * torch.rand(meta, generator=gen, device=dev))
    # tpu-ladder overflow probes: qs = 1 on row 3, |p| past 464 -> NaN
    p[3, :6] = torch.tensor([500.0, -470.0, 464.0, 463.9, 448.0, -1000.0],
                            device=dev)
    code.view(-1)[3], qs.view(-1)[3], lr.view(-1)[3] = 0, 1.0, 0.0
    return g, p, m, v, ids, lr, code, qs


def _apply_pair(ops, fu, args, kw):
    got = ops.fused_apply(*args, **kw)
    want = fu.fused_apply_ref(*args, **kw)
    torch.cuda.synchronize()
    for n, a, b in zip(("p", "m", "v", "cp", "p_amax"), got, want):
        check((a is None) == (b is None), n)
        if a is not None:
            check(a.dtype == b.dtype and a.shape == b.shape, n)
            check(same(a, b), f"fused_apply {n} differs ({kw})")
    return max(abs_err(a, b) for a, b in zip(got, want) if a is not None)


def check_apply_variants(dev):
    """Every variant the kernel is templated on, bitwise, on a small slab."""
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ops
    opts = [fu.OptSpec("sgdm", momentum=0.9, weight_decay=5e-4),
            fu.OptSpec("sgdm", momentum=0.9, nesterov=True,
                       weight_decay=1e-4),
            fu.OptSpec("adamw", b1=0.9, b2=0.95, eps=1e-8,
                       weight_decay=1e-2)]
    casts = [(torch.float32, False), (torch.bfloat16, False),
             (torch.bfloat16, True), (torch.float16, False)]
    n, err = 0, 0.0
    for spec in opts:
        adam = spec.kind == "adamw"
        g, p, m, v, ids, lr, code, qs = _apply_inputs(512, 3, dev, adam, 2)
        for ladder in ("gpu", "tpu"):
            for cp_dtype, sr in casts:
                for g_dtype in (torch.float32, torch.bfloat16, torch.float16):
                    if g_dtype != torch.float32 and cp_dtype != g_dtype:
                        continue
                    for keep in (1.0, 0.0):
                        gk = g.to(g_dtype).clone()
                        if not keep:
                            gk[9, 9] = float("inf")
                        scal = torch.tensor([0.5, keep, 0.19, 0.0975,
                                             12345.0], device=dev)
                        kw = dict(spec=spec, ladder=ladder,
                                  cp_dtype=cp_dtype, num_layers=3, sr=sr)
                        err = max(err, _apply_pair(
                            ops, fu, (gk, p, m, v, scal, ids, lr, code, qs),
                            kw))
                        n += 1
    log(f"fused_apply: {n} variants bitwise equal to the plain version")
    return err


def check_apply_main(view, dev, bw, f32_ops, spec=None,
                     g_dtype=torch.float32, cp_dtype=torch.float32,
                     ladder="gpu", sr=False, what="ResNet-18"):
    """fused_apply at a main path's shape and variant (ResNet-18's: sgdm
    with weight decay, gpu ladder, f32 gradient and copy) — bitwise
    against the plain version, then timed."""
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ops
    rows, L = view.rows, view.num_layers
    g, p, m, _, _, lr, _, qs = _apply_inputs(rows, L, dev, False, 3)
    g = g.to(g_dtype)
    rl = view.row_blocks(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    code = torch.randint(0, 3, rl.shape, generator=gen, device=dev,
                         dtype=torch.int32)
    if spec is None:
        spec = fu.OptSpec("sgdm", momentum=0.9, weight_decay=5e-4)
    check(spec.kind == "sgdm", "check_apply_main times the sgdm form")
    kw = dict(spec=spec, ladder=ladder, cp_dtype=cp_dtype, num_layers=L,
              sr=sr)
    scal = torch.tensor([0.5, 1.0, 1.0, 1.0, 7.0], device=dev)
    err = _apply_pair(ops, fu, (g, p, m, None, scal, rl, lr, code, qs), kw)
    lib = fu._lib()
    outs = [torch.empty_like(p), torch.empty_like(p),
            torch.empty(p.shape, dtype=cp_dtype, device=dev)]
    part = torch.empty((rows // lib.tri_rows_per_block()) * L, device=dev)
    pmax = torch.empty((L,), device=dev)
    ptrs = [t.data_ptr() for t in (g, p, m)] + [None] + \
        [t.data_ptr() for t in (scal, rl, lr, code, qs)] + \
        [t.data_ptr() for t in outs[:2]] + [None, outs[2].data_ptr(),
                                            part.data_ptr(), pmax.data_ptr()]

    def raw():          # the kernel alone: no checks, no allocation
        lib.tri_fused_apply(0, int(ladder == "tpu"),
                            fu._DTYPE_CODE[g_dtype], fu._DTYPE_CODE[cp_dtype],
                            int(sr), int(spec.nesterov), spec.momentum,
                            spec.b1, 1.0 - spec.b1, spec.b2, 1.0 - spec.b2,
                            spec.eps, spec.weight_decay, *ptrs, rows, L,
                            torch.cuda.current_stream().cuda_stream)

    ms = time_ms(raw, iters=20)
    dev_ms = device_ms(raw)
    plain_ms = time_ms(lambda: fu.fused_apply_ref(
        g, p, m, None, scal, rl, lr, code, qs, **kw), iters=3)
    elems = rows * 512          # g, p, m in; p, m, copy out
    nbytes = elems * (g.element_size() + 4 * 4 + outs[2].element_size()) \
        + 4 * rows * 4 + 5 * 4 + L * 4
    nops = elems * 16           # scale, wd, momentum, lr step, casts, absmax
    b_ms, by = bound(nbytes, nops, bw, f32_ops)
    log(f"fused_apply ({what}) {rows}x512 sgdm/{ladder}, g {g_dtype}, copy "
        f"{cp_dtype}: kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), max|err| {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None}


# --------------------------------------------- phase 3d: grad_stats ---
#: the reference's test shapes, then its benchmark's and its registry's
GS_SHAPES = [(64,), (513, 129), (1024, 512), (7, 3, 5), (8,), (300,),
             (1000,)]


def _cls(t) -> str:
    v = float(t)
    return "nan" if math.isnan(v) else (str(v) if math.isinf(v)
                                        else "finite")


def _gs_check(got, x, what, again=None) -> float:
    """One ``grad_stats`` result against the plain version on the same
    tensor: absmax bitwise (NaN equal to NaN), each sum within 2^-20 of
    the sum of its terms' magnitudes of an f64 sum (an f32 sum in another
    order), non-finite statistics in the same class, and a second launch
    bitwise equal (``again``). Returns max |kernel - plain|."""
    from repro_torch.kernels import grad_stats as gs
    want = gs.grad_stats_ref(x)
    check(same(got[2], want[2]), f"grad_stats absmax {what}: {got[2]} vs "
          f"{want[2]}")
    v = x.detach().double().reshape(-1)
    fin = bool(torch.isfinite(v).all())
    for k, (truth, mass) in enumerate(((v.sum(), v.abs().sum()),
                                       ((v * v).sum(), (v * v).sum()))):
        g = got[k].double()
        if fin:
            check(float((g - truth).abs()) <= 2.0 ** -20 * float(mass),
                  f"grad_stats {('sum', 'sum_sq')[k]} {what}: {float(g)!r} "
                  f"vs f64 {float(truth)!r} (sum of |terms| "
                  f"{float(mass)!r})")
        else:
            check(_cls(g) == _cls(want[k]),
                  f"grad_stats {what}: {float(g)} vs {float(want[k])}")
    if again is not None:
        check(all(same(a, b) for a, b in zip(got, again)),
              f"grad_stats {what}: two launches differ")
    return max(abs_err(a, b) for a, b in zip(got, want))


def _time_grad_stats(xs, bw, f32_ops, what):
    """CUDA-event time of the kernel alone over the tensors ``xs`` in turn
    (enough of them that each launch reads its input from device memory,
    not from the 50 MB L2), the plain version's time, and the bound."""
    from repro_torch.kernels import grad_stats as gs
    lib = gs._lib()
    x = xs[0]
    code, n = gs._DTYPE_CODE[x.dtype], x.numel()
    nblk = lib.tri_grad_stats_blocks(n, code)
    part = torch.empty((3 * nblk,), device=x.device)
    out = torch.empty((3,), device=x.device)
    k = [0]

    def raw():          # the kernel alone: no checks, no allocation
        k[0] = (k[0] + 1) % len(xs)
        lib.tri_grad_stats(xs[k[0]].data_ptr(), code, n, part.data_ptr(),
                           nblk, out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)

    ms = time_ms(raw, iters=30)
    plain_ms = time_ms(lambda: gs.grad_stats_ref(x), iters=10)
    # each input byte read once, 3 f32 written; 4 operations an element
    # (add, multiply-add, abs, max)
    b_ms, by = bound(n * x.element_size() + 12, 4 * n, bw, f32_ops)
    log(f"grad_stats {what} {tuple(x.shape)} {x.dtype}: kernel {ms:.5f} ms, "
        f"plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms ({by}), {nblk} "
        "blocks; no single PyTorch call computes the three moments (no "
        "library time)")
    return ms, plain_ms, b_ms, by


def check_grad_stats(dev, bw, f32_ops):
    """``grad_stats`` against its plain version on the card: the
    reference's test shapes (f32, bf16), its benchmark's (1024, 1024) f32
    and its registry's (1,000,000,) f32, an empty tensor, tensors holding
    NaN, +inf, -inf (and a strided view); timed at (1024, 1024) f32."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(5)
    err, n = 0.0, 0
    cases = [(s, d) for s in GS_SHAPES
             for d in (torch.float32, torch.bfloat16)]
    cases += [((1024, 1024), torch.float32), ((1_000_000,), torch.float32)]
    for shape, dtype in cases:
        x = (torch.randn(shape, generator=gen, device=dev) * 2).to(dtype)
        err = max(err, _gs_check(ops.grad_stats(x), x, f"{shape} {dtype}",
                                 ops.grad_stats(x)))
        n += 1
    empty = ops.grad_stats(torch.empty((0,), device=dev))
    check([float(t) for t in empty] == [0.0] * 3, "grad_stats of nothing")
    for bad in (float("nan"), float("inf"), -float("inf")):
        x = torch.randn((513, 129), generator=gen, device=dev)
        x[7, 100] = bad
        _gs_check(ops.grad_stats(x), x, f"holding {bad}")
        _gs_check(ops.grad_stats(x.T), x.T, f"holding {bad}, transposed")
    both = torch.randn((513, 129), generator=gen, device=dev)
    both[1, 1], both[2, 2] = float("inf"), -float("inf")
    got = ops.grad_stats(both)
    _gs_check(got, both, "holding +inf and -inf")
    check(bool(torch.isnan(got[0])) and float(got[2]) == float("inf"),
          "grad_stats: inf - inf sums to NaN, absmax inf")
    torch.cuda.synchronize()
    log(f"grad_stats: {n} shapes x 2 launches, empty, NaN/+inf/-inf and "
        f"strided inputs held against the plain version; max|kernel - "
        f"plain| {err:.3g}")
    # 16 x 4 MB: each timed launch finds its input out of the L2
    xs = [torch.randn((1024, 1024), generator=gen, device=dev)
          for _ in range(16)]
    ms, plain_ms, b_ms, by = _time_grad_stats(xs, bw, f32_ops,
                                              "(the reference benchmark's)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def grad_stats_over_gradients(name, task, params, aux, batch, tac,
                              control, bw=None, f32_ops=None,
                              whole_tree=False):
    """The port's path to ``grad_stats``: its public op over every leaf of
    the gradient tree of one reference step (``train_step.reference_grads``:
    the main path's loss and batch, f32 after the loss-scale division).
    The launch count is read around the op's calls alone; the results are
    then held against the plain version (no kernel launch). With ``bw``
    given, timed on the largest leaf, or with ``whole_tree`` over every
    leaf in turn (the path's own work: one launch a leaf)."""
    from repro_torch import tree as tu
    from repro_torch.core.precision import make_qdq_fn
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import reference_grads
    grads, _, metrics = reference_grads(task, make_qdq_fn(tac), params, aux,
                                        batch, task.loss_codes(control.codes),
                                        control.loss_scale)
    leaves = tu.leaves(grads)
    torch.cuda.synchronize()
    ops.reset_launches()
    stats = [ops.grad_stats(g) for g in leaves]
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(launches["grad_stats"] == len(leaves) and sum(
        launches.values()) == len(leaves),
        f"grad_stats over {name}'s gradient leaves: {launches}")
    err = max(_gs_check(st, g, f"{name} leaf {tuple(g.shape)}")
              for st, g in zip(stats, leaves))
    big = max(leaves, key=lambda g: g.numel())
    log(f"grad_stats over the {len(leaves)} gradient leaves of one "
        f"reference step of {name} ({sum(g.numel() for g in leaves)} "
        f"elements, largest {tuple(big.shape)} {big.dtype}): "
        f"{launches['grad_stats']} launches, all held against the plain "
        f"version, max|kernel - plain| {err:.3g}; that step's loss "
        f"{float(metrics['loss']):.5f}")
    out = {"launches": launches["grad_stats"], "max_abs_err": err}
    if bw is not None and whole_tree:
        out.update(_time_grad_stats_tree(leaves, bw, f32_ops, name))
    elif bw is not None:        # time the largest leaf (113 MB: out of L2)
        ms, plain_ms, b_ms, by = _time_grad_stats(
            [big], bw, f32_ops, f"{name}'s largest gradient leaf")
        out.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                   library_ms=None)
    return out


def _time_grad_stats_tree(leaves, bw, f32_ops, name) -> dict:
    """One pass of the kernel over every leaf in turn (one launch a leaf,
    buffers allocated beforehand), by CUDA events and by the profiler's
    device time; the plain version over the same leaves; the bound: every
    leaf's bytes read once, 3 f32 written a leaf."""
    from repro_torch.kernels import grad_stats as gs
    lib = gs._lib()
    stream = torch.cuda.current_stream().cuda_stream
    calls = []
    for x in leaves:
        code, n = gs._DTYPE_CODE[x.dtype], x.numel()
        nblk = lib.tri_grad_stats_blocks(n, code)
        calls.append((x.contiguous(), code, n,
                      torch.empty((3 * nblk,), device=x.device), nblk,
                      torch.empty((3,), device=x.device)))

    def raw():          # the kernel alone: no checks, no allocation
        for x, code, n, part, nblk, out in calls:
            lib.tri_grad_stats(x.data_ptr(), code, n, part.data_ptr(), nblk,
                               out.data_ptr(), stream)

    ms = time_ms(raw, iters=5)
    dev_ms = device_ms(raw, iters=5)
    plain_ms = time_ms(lambda: [gs.grad_stats_ref(x) for x in leaves],
                       iters=3)
    n = sum(x.numel() for x in leaves)
    b_ms, by = bound(sum(x.numel() * x.element_size() for x in leaves)
                     + 12 * len(leaves), 4 * n, bw, f32_ops)
    small = sum(x.numel() <= 1280 for x in leaves)
    log(f"grad_stats over {name}'s {len(leaves)} gradient leaves in turn "
        f"({n} elements; {small} leaves of at most 1,280): kernel "
        f"{ms:.5f} ms by events, device {dev_ms:.5f} ms "
        f"({dev_ms / len(leaves) * 1e3:.2f} us a launch), plain "
        f"{plain_ms:.5f} ms, bound {b_ms:.5f} ms ({by}); no single PyTorch "
        "call computes the three moments (no library time)")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


# ------------------------------------------ phase 4: one step, two devices ---
def check_step_against_cpu(arch: str = "resnet18", floor: float = 0.0):
    """One resident step of ``arch`` at batch 4 on the card (kernels) and
    on the CPU (plain versions), from the same weights, state and batch.
    cuDNN and the CPU convolve in other summation orders (both full f32,
    TF32 off), so the gradient is held leaf by leaf within 3e-2 of the
    leaf's largest magnitude (the spread the reference's own CPU gradient
    shows against f64 in ResNet-18's first block; see
    tests/test_torch_vision.py) plus ``floor`` of the slab's largest
    magnitude (EfficientNet-B0: 1e-5, for the projections' BatchNorm
    biases, whose exact gradient is zero and whose f32 noise is all either
    side computes; tests/test_torch_vision_effnet.py), and everything
    downstream of it follows from the gradient by the update's
    arithmetic:
      master   p_card - p_cpu = -lr * (m_card - m_cpu), up to one f32
               rounding on each side, each relative to its own values,
               2^-21 (|p| + |p'_card| + |p'_cpu|), as the reference step's
               check (where p is 0 and m noise, p'_card and p'_cpu differ
               wholly)
      copy     within one grid step of its tier (2^-7) of the master's gap
    loss and BN statistics within rtol 1e-4, codes equal."""
    from repro_torch import tree as tu
    from repro_torch.core.precision import TriAccelConfig
    from repro_torch.data.synthetic import CIFARLikeStream
    from repro_torch.models.vision import VisionConfig
    from repro_torch.train.task import VisionTask
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tac = TriAccelConfig(ladder="gpu", t_ctrl=1, curvature_method="fisher",
                         tau_low=3e-9, tau_high=1e-5)
    tcfg = TrainerConfig(total_steps=10, base_lr=0.05, warmup_steps=2,
                         weight_decay=5e-4, grad_clip=5.0, rungs=(4,),
                         seq_len=1)
    batch = CIFARLikeStream(global_batch=4, seed=3).batch(0)
    out = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(VisionTask(VisionConfig(arch), device=dev), tac,
                     tcfg, device=dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        st, met = tr._step_fn(tr.state, b)
        out[dev] = (tr.state.params.cpu(), st, met)
    view = tr.view
    (p0, sc, mc), (_, sg, mg) = out["cpu"], out["cuda"]
    cpu = lambda t: t.detach().cpu().float()
    check(bool(mg["grads_finite"]) and bool(torch.isfinite(mg["loss"])),
          "finite step on the card")
    torch.testing.assert_close(cpu(mg["loss"]), mc["loss"], rtol=1e-4,
                               atol=0)
    mo_g, mo_c = cpu(sg.opt_state["mu"]), sc.opt_state["mu"]
    worst, top = 0.0, float(mo_c.abs().max())
    for slot in view.slots:
        rows = slice(slot.row_off, slot.row_off + slot.stack * slot.rows_per)
        gap = float((mo_g[rows] - mo_c[rows]).abs().max())
        worst = max(worst, gap / (float(mo_c[rows].abs().max())
                                  + floor / 3e-2 * top))
    check(worst <= 3e-2, f"{arch} card vs CPU clipped gradient: {worst}")
    lr = float(mc["lr"])
    check(float(mg["lr"]) == lr, "learning rate")
    p_g, p_c = cpu(sg.params), sc.params
    dev_p = ((p_g - p_c) + lr * (mo_g - mo_c)).abs()
    check(bool((dev_p <= 2.0 ** -21 * (p0.abs() + p_c.abs()
                                       + p_g.abs())).all()),
          "master = p - lr * m on both devices")
    gap_p = float((p_g - p_c).abs().max())
    cp_g, cp_c = cpu(sg.compute["slab"]), sc.compute["slab"].float()
    check(bool(((cp_g - cp_c).abs() <= 2.0 ** -7 * cp_c.abs() + 2 * gap_p
                + 2.0 ** -24).all()), "compute copy")
    check(torch.equal(sg.control.codes.cpu(), sc.control.codes), "codes")
    for a, b in zip(tu.leaves(sg.aux_state), tu.leaves(sc.aux_state)):
        torch.testing.assert_close(cpu(a), b, rtol=1e-4, atol=1e-5)
    log(f"{arch}, one step, card vs CPU: loss {float(mg['loss']):.7f} vs "
        f"{float(mc['loss']):.7f}; momentum (the clipped gradient) within "
        f"{worst:.3g} of each leaf's max; max|dmaster| {gap_p:.3g}; codes "
        f"{sg.control.codes.tolist()}")


def check_curvature_against_cpu(arch: str = "efficientnet_b0",
                                b_curv: int = 4, step: int = 40) -> None:
    """One §3.2 ``hutchinson`` refresh as ``Trainer._curvature`` takes it
    (``curvature.hutchinson_layer_traces``, one probe from a generator
    seeded with ``step``, the task's ``curvature_loss`` over ``b_curv``
    images) on the card and on the CPU, from the same weights, BatchNorm
    state, batch and probe. Each layer's trace estimate is a sum of
    z * (Hz) terms of both signs, so it is held within 1e-3 of the layer's
    mean |z * (Hz)| (the sum's conditioning), computed on the CPU."""
    from repro_torch import tree as tu
    from repro_torch.core import curvature as curv
    from repro_torch.core.grouping import flat_grouping
    from repro_torch.data.synthetic import CIFARLikeStream
    from repro_torch.models.vision import VisionConfig
    from repro_torch.train.task import VisionTask
    batch = CIFARLikeStream(global_batch=b_curv, seed=3).batch(step)
    params, aux = VisionTask(VisionConfig(arch), device="cpu").init(
        torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        task = VisionTask(VisionConfig(arch), device=dev)
        p = tu.tree_map(lambda t: t.to(dev), params)
        a = tu.tree_map(lambda t: t.to(dev), aux)
        b = {k: v.to(dev) for k, v in batch.items()}
        loss_fn = lambda q, bb: task.curvature_loss(q, a, bb)  # noqa: E731
        grp = flat_grouping(p)
        t0 = time.perf_counter()
        lam = curv.hutchinson_layer_traces(
            loss_fn, p, grp.mean, torch.Generator().manual_seed(step), 1, b)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (lam.cpu(), (time.perf_counter() - t0) * 1e3)
        if dev == "cpu":
            z = curv._rademacher_tree(p, torch.Generator().manual_seed(step))
            hz = curv.hvp(loss_fn, p, z, b)
            mass = grp.mean(tu.tree_map(lambda x, y: (x * y).abs(), z, hz))
    (lc, ms_c), (lg, ms_g) = out["cpu"], out["cuda"]
    check(bool(torch.isfinite(lg).all()) and float(lg.abs().sum()) > 0,
          f"hutchinson on the card: {lg.tolist()}")
    worst = float(((lg - lc).abs() / mass).max())
    check(worst <= 1e-3, f"{arch} hutchinson card vs CPU: {worst} of the "
          "layers' mean |z Hz|")
    log(f"{arch}, one hutchinson refresh (b_curv {b_curv}, one probe), card "
        f"vs CPU: per-layer traces within {worst:.3g} of each layer's mean "
        f"|z Hz| (limit 1e-3); card {ms_g:.1f} ms, CPU {ms_c:.1f} ms; "
        f"lambda {[float(f'{x:.3g}') for x in lg.tolist()]}")


# ------------------------------------------------- phase 5: main path ---
def main_path(steps: int, batch0: int, arch: str = "resnet18"):
    """``run_method("triaccel", arch, steps, batch0)`` with the launch
    counts read around it -> (launches, median step ms, peak bytes, rung
    history)."""
    from repro_torch.kernels import ops
    from repro_torch.train.paper_harness import run_method
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run_method("triaccel", arch, steps=steps, batch0=batch0,
                     device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in res.log]
    check(len(res.log) == steps, f"{len(res.log)} logged steps")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    for k in ("fused_stats", "fused_apply"):
        check(launches[k] == steps, f"{k}: {launches[k]} launches in "
              f"{steps} steps")
    if steps > 40:      # t_ctrl = 10, t_curv = 40: each control fired
        check(len(res.batch_history) == (steps - 1) // 10,
              "rung controller every 10 steps")
        check(res.codes != [1] * len(res.codes), "precision codes refreshed")
        check(max(res.curvature) > 0, "fisher curvature refreshed")
    walls = [m["wall_s"] for m in res.log]
    dts = [b - a for a, b in zip(walls, walls[1:])]
    step_ms = statistics.median(dts[4:]) * 1e3
    hist = {c: res.codes.count(c) for c in (0, 1, 2)}
    log(f"main path: run_method('triaccel', '{arch}', steps={steps}, "
        f"batch0={batch0}) in {wall:.2f} s (eval included)")
    log(f"  median step {step_ms:.3f} ms (steps 5..{steps - 1}), "
        f"peak allocated {peak / 1e9:.3f} GB")
    log(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f}, finite steps "
        f"{sum(int(m['grads_finite']) for m in res.log)}/{steps}, "
        f"held-out accuracy {res.accuracy:.2f} %")
    log(f"  rung history {res.batch_history}, final rung "
        f"{res.final_batch}, measured peak bytes per rung "
        f"{ {k: int(v) for k, v in res.measured_bytes.items()} }")
    log(f"  codes {res.codes} histogram {hist}, loss scale "
        f"{res.log[-1]['loss_scale']:.0f}, fisher curvature per layer "
        f"{[float(f'{x:.3g}') for x in res.curvature]}")
    log(f"  launches {launches}")
    return launches, step_ms, peak, res.batch_history


def hutchinson_main_path(arch: str = "efficientnet_b0", t_curv: int = 5,
                         rung: int = 32) -> None:
    """A ``Trainer`` with ``TriAccelConfig()``'s defaults (the
    ``hutchinson`` method; only ``t_curv`` lowered so the refresh fires)
    for ``t_curv + 1`` steps on the card: the refresh at step ``t_curv``
    sets a finite, non-zero per-layer curvature. Then the time of one more
    refresh (one probe, double backward over ``b_curv`` images)."""
    from repro_torch.core.precision import TriAccelConfig
    from repro_torch.kernels import ops
    from repro_torch.models.vision import VisionConfig
    from repro_torch.train.task import VisionTask
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tac = TriAccelConfig(t_curv=t_curv)
    check(tac.curvature_method == "hutchinson", "the default method")
    tr = Trainer(VisionTask(VisionConfig(arch), device="cuda"), tac,
                 TrainerConfig(total_steps=t_curv + 1, seq_len=1,
                               rungs=(rung,), log_every=1), device="cuda")
    ops.reset_launches()
    tr.run(t_curv)
    check(float(tr.state.control.lam.abs().sum()) == 0.0,
          "no curvature before the first refresh")
    tr.run(1)
    torch.cuda.synchronize()
    lam = tr.state.control.lam.cpu()
    launches = dict(ops.LAUNCHES)
    check(bool(torch.isfinite(lam).all()) and float(lam.abs().sum()) > 0,
          f"hutchinson refresh on the card: {lam.tolist()}")
    check(launches["fused_stats"] == launches["fused_apply"] == t_curv + 1,
          f"hutchinson trainer launches {launches}")
    check(all(math.isfinite(m["loss"]) for m in tr.metrics_log),
          "hutchinson trainer losses")
    t0 = time.perf_counter()
    tr._curvature(t_curv)
    torch.cuda.synchronize()
    log(f"hutchinson main path: Trainer(VisionTask({arch!r}), "
        f"TriAccelConfig(t_curv={t_curv})) {t_curv + 1} steps at rung "
        f"{rung}, b_curv {tr.tcfg.b_curv}: lambda per layer "
        f"{[float(f'{x:.3g}') for x in lam.tolist()]}; one more refresh "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms; launches "
        f"{ {k: v for k, v in launches.items() if v} }")


def _profile(run, steps: int, family, what: str) -> None:
    """``torch.profiler`` over ``run()`` (``steps`` steps): device time by
    ``family(kernel name)``, the union of the device intervals (busy), the
    host gaps and the idle share of the host's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.events() if e.device_type == cuda]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, end = 0.0, -1.0
    for a, b in spans:                   # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    fam, top = {}, {}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        key = family(e.name.lower())
        fam[key] = fam.get(key, 0.0) + us
        top[e.name] = top.get(e.name, 0.0) + us
    log(f"profile, {what}: host {wall_us / steps / 1e3:.3f} ms a step, "
        f"device busy {busy / steps / 1e3:.3f} ms a step, host gaps "
        f"{(wall_us - busy) / steps / 1e3:.3f} ms a step, idle share "
        f"{1 - busy / wall_us:.3f}; {len(kern) / steps:.0f} device ops a "
        "step")
    for k, v in sorted(fam.items(), key=lambda kv: -kv[1]):
        log(f"  {k}: {v / steps / 1e3:.4f} ms a step")
    for n, v in sorted(top.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {v / steps / 1e3:8.4f} ms  {n[:100]}")


def profile_steps(batch0: int, warm: int = 6, steps: int = 5,
                  method: str = "triaccel", arch: str = "resnet18") -> None:
    """Where a train step's time goes: ``steps`` steps of the ``method``
    main path's trainer for ``arch`` after ``warm`` steps."""
    from repro_torch.train.paper_harness import make_trainer
    trainer = make_trainer(method, arch, steps=50, batch0=batch0,
                           device="cuda")[0]
    trainer.run(warm)

    def family(n):
        if "stats_partials" in n or "apply_kernel" in n \
                or "reduce_partials" in n:
            return "fused update (this port's kernels)"
        if any(w in n for w in ("conv", "gemm", "xmma", "cudnn", "wgrad",
                                "dgrad", "cutlass", "sm90")):
            return "convolution / matmul"
        if "memcpy" in n or "memset" in n:
            return "memcpy / memset"
        return "reduction" if "reduce" in n else "elementwise / other"

    _profile(lambda: trainer.run(steps), steps, family,
             f"{steps} {method} train steps of {arch} at rung "
             f"{trainer.scaler.microbatch}")


# ------------------------------------ phase 3b: the serving kernels ---
def close(got, want, what) -> float:
    """An attention kernel's output against its plain version's, within
    ``flash_attention.tolerance`` (the source's stated tolerance); returns
    max |err|."""
    from repro_torch.kernels.flash_attention import tolerance
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    d = (g - w).abs()
    lim = tolerance(got, want)
    worst = int(torch.argmax(d / lim))
    check(bool((d <= lim).all()),
          f"{what}: max|err| {float(d.max())}; worst against its limit "
          f"{float(g.flatten()[worst])} vs {float(w.flatten()[worst])}")
    return float(d.max())


def close_lse(got, want, what) -> None:
    """The forward kernel's LSE against the plain forward's: within 1e-5
    of 1 + the largest |lse| (f32 sums of exp in another order)."""
    check(bool((got - want).abs().max() <= 1e-5 * (1 + want.abs().max())),
          what + " lse")


def _lm_leaves():
    """The floating leaves of smollm-135m's parameters, as shapes."""
    from repro_torch import tree as tu
    from repro_torch.configs import smollm_135m
    from repro_torch.models.lm import lm_init
    params = lm_init(torch.Generator(), smollm_135m.config(), device="meta")
    return [tuple(x.shape) for x in tu.leaves(params)]


def _device_ops(fn):
    """Names of the operations one ``fn()`` call puts on the card
    (``torch.profiler``, after a warm-up call; a trace that came back
    empty is taken again, as in ``device_ms``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return []


def _qdq_edges(dev, ops, qc) -> int:
    """The kernel against its plain version at offsets 0-7 elements into a
    buffer (every alignment of x against the fresh output), sizes around
    the 8-element unit, f32 and bf16 in and out, NaN and +-inf in x, both
    ladders, no / given / too-small amax, codes 0/1/2; ten repeated calls
    of each form bitwise equal. Returns the cases checked."""
    gen = torch.Generator(device=dev).manual_seed(6)
    edges = torch.tensor([float("nan"), float("inf"), -float("inf"), 7e4,
                          -1e-30, 448.0, 12.0], device=dev)
    amaxes = (None, torch.tensor(9.5, device=dev),
              torch.tensor(0.5, device=dev))
    n_cases = 0
    for n in (0, 1, 7, 8, 9, 15, 16, 17, 1_048_579):
        buf32 = torch.randn((n + 8,), generator=gen, device=dev) * 3.0
        if n > 64:
            buf32[n // 2:n // 2 + len(edges)] = edges
        for dtype in (torch.float32, torch.bfloat16):
            buf = buf32.to(dtype)
            for off in range(8):
                x = buf[off:off + n]
                for out_dtype in (torch.float32, torch.bfloat16):
                    for ladder in ("tpu", "gpu"):
                        for amax in amaxes:
                            for code in (0, 1, 2):
                                got = ops.qdq_cast(x, code, ladder, amax,
                                                   out_dtype=out_dtype)
                                want = qc.qdq_cast_ref(x, code, ladder, amax,
                                                       out_dtype=out_dtype)
                                check(got.dtype == out_dtype
                                      and got.shape == x.shape
                                      and same(got, want),
                                      f"qdq_cast n={n} off={off} {dtype} -> "
                                      f"{out_dtype} {ladder} amax={amax} "
                                      f"code={code}")
                                n_cases += 1
    x = (torch.randn((1_048_582,), generator=gen, device=dev) * 3.0)[3:]
    for amax in (None, x.abs().amax()):
        first = ops.qdq_cast(x, 0, "tpu", amax, out_dtype=torch.bfloat16)
        for _ in range(9):
            again = ops.qdq_cast(x, 0, "tpu", amax, out_dtype=torch.bfloat16)
            check(torch.equal(again.view(torch.int16),
                              first.view(torch.int16)),
                  f"qdq_cast repeats bitwise (amax={amax is not None})")
    return n_cases


def check_qdq(dev, bw, ops_rate):
    """qdq_cast bitwise against its plain version over every variant
    (ladders, codes, f32/bf16, tile-filling and ragged sizes, no / given /
    too-small amax with the NaN rule) and the edge cases (``_qdq_edges``),
    each form's device operations per call, then at the main paths'
    shapes: the tier-0 cast of all of smollm-135m's leaves, timed whole by
    CUDA events and by the profiler's device time. Rows 3 and 4 of
    ``PERF.md`` (f32 in and out): the two-pass form, and the one-pass form
    with each leaf's absmax given. Row 3b, the serving tier-0 weight set
    (f32 in, bf16 out): the cast then ``.to(bf16)`` against the bf16
    output written directly, timed in turns. Yardsticks: the kernel as a
    copy (code 2) beside ``torch.clone``. -> the ``kernels`` line's rows
    ``qdq_cast`` (the serving path's two-pass cast, bf16 out) and
    ``qdq_cast_one_pass`` (the LM path's cast from the trainer's table)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import qdq_cast as qc
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 0
    for shape in ((512, 512), (37, 53), (30, 576, 9, 64)):
        x32 = torch.randn(shape, generator=gen, device=dev) * 3.0
        x32.view(-1)[:4] = torch.tensor([7e4, -1e-30, 448.0, 12.0])
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for ladder in ("tpu", "gpu"):
                for amax in (None, torch.tensor(9.5, device=dev),
                             torch.tensor(0.5, device=dev)):
                    for code in (0, 1, 2):
                        got = ops.qdq_cast(x, code, ladder, amax)
                        want = qc.qdq_cast_ref(x, code, ladder, amax)
                        check(got.dtype == x.dtype, "qdq dtype")
                        check(same(got, want), f"qdq_cast {shape} {dtype} "
                              f"{ladder} amax={amax} code={code}")
                        n += 1
    small = torch.tensor([4.2, -5.0, 0.5], device=dev)
    nan = ops.qdq_cast(small, 0, "tpu", torch.tensor(4.0, device=dev))
    check(bool(torch.isnan(nan[:2]).all()) and not bool(torch.isnan(nan[2])),
          "qdq_cast: NaN past 464 on the tpu ladder")
    edges = _qdq_edges(dev, ops, qc)
    log(f"qdq_cast: {n} variants and {edges} edge cases (offsets 0-7, sizes "
        "0-17 and 1,048,579, f32/bf16 in and out, NaN/inf, ten repeats) "
        "bitwise equal to the plain version")

    # main path: every leaf of the full-width model, f32 in
    xs = [torch.randn(s, generator=gen, device=dev) * 0.05
          for s in _lm_leaves()]
    amaxes = [x.abs().amax() for x in xs]
    big = max(xs, key=lambda t: t.numel())
    norm = min(xs, key=lambda t: t.numel())
    for x in (big, norm):
        for form, amax in (("two_pass", None), ("one_pass", x.abs().amax())):
            names = _device_ops(lambda: ops.qdq_cast(
                x, 0, "tpu", amax, out_dtype=torch.bfloat16))
            log(f"qdq_cast {form} call on {tuple(x.shape)}: {len(names)} "
                f"device operation(s) {names}")
            check(len(names) == 1 and "qdq_kernel" in names[0],
                  f"qdq_cast {form}: one device operation a call")
            # the kernel's TWO_PASS template argument is the form counted
            check(f"{str(form == 'two_pass').lower()}>" in names[0],
                  f"qdq_cast {form}: the launched kernel is that form")
    err = 0.0
    for x, a in zip(xs, amaxes):
        for amax in (None, a):
            for out_dtype in (torch.float32, torch.bfloat16):
                got = ops.qdq_cast(x, 0, "tpu", amax, out_dtype=out_dtype)
                want = qc.qdq_cast_ref(x, 0, "tpu", amax, out_dtype=out_dtype)
                check(same(got, want), f"qdq_cast leaf {tuple(x.shape)} "
                      f"amax={amax is not None} {out_dtype}")
                err = max(err, abs_err(got, want))
    lib = qc._lib()
    grid = lib.tri_qdq_cast_max_grid()
    partials = torch.empty((grid,), dtype=torch.int32, device=dev)
    outs = {d: [torch.empty(x.shape, dtype=d, device=dev) for x in xs]
            for d in (torch.float32, torch.bfloat16)}
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16

    def raw(out_dtype, code=0, given=False):
        """The kernel alone, no checks, no allocation: one call a leaf."""
        oc = qc._DTYPE_CODE[out_dtype]

        def run():
            for x, o, a in zip(xs, outs[out_dtype], amaxes):
                lib.tri_qdq_cast(x.data_ptr(), 0, o.data_ptr(), oc,
                                 x.numel(), code, 1,
                                 a.data_ptr() if given else None,
                                 int(qc.form(code, "tpu", a if given
                                             else None) == "two_pass"),
                                 partials.data_ptr(), grid, stream)
        return run

    def plain(out_dtype, given=False):
        return lambda: [qc.qdq_cast_ref(x, 0, "tpu", a if given else None,
                                        out_dtype=out_dtype)
                        for x, a in zip(xs, amaxes)]

    elems = sum(x.numel() for x in xs)

    def bnd(per_elem):
        return bound(per_elem * elems, 6.0 * elems, bw, ops_rate)

    t = {}
    for key, fn in (("two", raw(torch.float32)),
                    ("one", raw(torch.float32, given=True)),
                    ("two_bf", raw(bf)), ("one_bf", raw(bf, given=True)),
                    ("copy", raw(torch.float32, code=2))):
        t[key] = (time_ms(fn, iters=10), device_ms(fn, iters=10))
    t["clone"] = (time_ms(lambda: [x.clone() for x in xs], iters=10),
                  device_ms(lambda: [x.clone() for x in xs], iters=10))
    # row 3b: the serving set as the cast then .to(bf16), against the bf16
    # output written directly, in turns (chain, direct, direct, chain)
    chain = lambda: [ops.qdq_cast(x, 0, "tpu").to(bf) for x in xs]  # noqa
    direct = lambda: [ops.qdq_cast(x, 0, "tpu", out_dtype=bf)  # noqa
                      for x in xs]
    turns = [time_ms(f, iters=5, reps=3) for f in (chain, direct, direct,
                                                   chain)]
    dev_chain, dev_direct = device_ms(chain, 5), device_ms(direct, 5)
    p = {"two": time_ms(plain(torch.float32), iters=2, reps=3),
         "one": time_ms(plain(torch.float32, True), iters=2, reps=3),
         "two_bf": time_ms(plain(bf), iters=2, reps=3),
         "one_bf": time_ms(plain(bf, True), iters=2, reps=3)}
    b8, b12, b10, b6 = bnd(8.0), bnd(12.0), bnd(10.0), bnd(6.0)
    log(f"qdq_cast, tier-0 cast of {len(xs)} leaves ({elems} f32 weights), "
        f"ms by events (device ms by the profiler), plain version beside:")
    log(f"  row 3, two-pass, f32 out: {t['two'][0]:.4f} ({t['two'][1]:.4f}),"
        f" plain {p['two']:.4f}; bound {b8[0]:.4f} (8 B an element), "
        f"{b12[0]:.4f} for a design that reads x twice (12 B)")
    log(f"  row 4, one-pass (each leaf's amax given), f32 out: "
        f"{t['one'][0]:.4f} ({t['one'][1]:.4f}), plain {p['one']:.4f}; "
        f"bound {b8[0]:.4f} (8 B)")
    log(f"  row 3b, bf16 out: two-pass {t['two_bf'][0]:.4f} "
        f"({t['two_bf'][1]:.4f}), plain {p['two_bf']:.4f}; one-pass "
        f"{t['one_bf'][0]:.4f} ({t['one_bf'][1]:.4f}), plain "
        f"{p['one_bf']:.4f}; bound {b6[0]:.4f} (6 B an element), "
        f"{b10[0]:.4f} for a design that reads x twice (10 B)")
    log(f"  row 3b, the serving set through ops.qdq_cast, in turns: cast + "
        f".to(bf16) {turns[0]:.4f} / {turns[3]:.4f} (device "
        f"{dev_chain:.4f}), bf16 written directly {turns[1]:.4f} / "
        f"{turns[2]:.4f} (device {dev_direct:.4f})")
    log(f"  yardsticks: the kernel as a copy (code 2, f32) {t['copy'][0]:.4f}"
        f" ({t['copy'][1]:.4f}), torch's clone {t['clone'][0]:.4f} "
        f"({t['clone'][1]:.4f})")
    common = {"max_abs_err": err, "library_ms": None}
    rows = {
        "qdq_cast": {"ms": t["two_bf"][0], "plain_ms": p["two_bf"],
                     "bound_ms": b6[0], "bound_by": b6[1],
                     "reread_bound_ms": b10[0],
                     "device_ms": t["two_bf"][1],
                     "f32_out_ms": t["two"][0],
                     "f32_out_device_ms": t["two"][1],
                     "f32_out_plain_ms": p["two"],
                     "f32_out_bound_ms": b8[0],
                     "f32_out_reread_bound_ms": b12[0],
                     "chain_ms": [turns[0], turns[3]],
                     "direct_ms": [turns[1], turns[2]],
                     "copy_ms": t["copy"][0], "clone_ms": t["clone"][0]},
        "qdq_cast_one_pass": {"ms": t["one_bf"][0], "plain_ms": p["one_bf"],
                              "bound_ms": b6[0], "bound_by": b6[1],
                              "device_ms": t["one_bf"][1],
                              "f32_out_ms": t["one"][0],
                              "f32_out_device_ms": t["one"][1],
                              "f32_out_plain_ms": p["one"],
                              "f32_out_bound_ms": b8[0]}}
    return {k: {**common, **v} for k, v in rows.items()}


def _segments(B, S, dev, seed):
    g = torch.Generator().manual_seed(seed)
    seg = torch.zeros((B, S), dtype=torch.int32)
    for b in range(B):
        for c in torch.randperm(S - 1, generator=g)[:3] + 1:
            seg[b, int(c):] += 1
    return seg.to(dev)


def _sdpa(q, k, v, **kw):
    """torch's own attention on (B, S, H, D) tensors: the yardstick, timed
    here and used nowhere in the port. Grouped heads through
    ``enable_gqa`` where this torch has it, else K/V repeated per head."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                              **kw)
    except TypeError:
        rep = q.shape[2] // k.shape[2]
        return F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1),
            **kw)


#: (D, Dv) at which the tensor-core forward is held to the plain version:
#: the test and LM head dims, the wide heads, and a Dv != D
TC_HEAD_DIMS = ((16, 16), (64, 64), (128, 128), (192, 192), (256, 256),
                (192, 128))


def _flash_pair(q, k, v, seg, kw, what, route):
    """The forward kernel of ``route`` (checked against ``fwd_route``)
    against the plain forward, o within ``tolerance`` and the LSE within
    ``close_lse``."""
    from repro_torch.kernels import flash_attention as fa
    check(fa.fwd_route(q.dtype, q.shape[-1], v.shape[-1]) == route,
          f"{what}: the {route} route")
    o, lse = fa.flash_attention_cuda(q, k, v, seg, with_lse=True, **kw)
    o_r, lse_r = fa.flash_attention_ref(q, k, v, seg, with_lse=True, **kw)
    err = close(o, o_r, what)
    close_lse(lse, lse_r, what)
    return err


def check_flash(dev, bw, f32_ops, tc_rate):
    """Both forward kernels against the plain version. The tensor-core
    kernel (bf16) over every variant (causal, not causal, window,
    segments), GQA rep 1 and 3 and each (D, Dv) of ``TC_HEAD_DIMS`` at S
    256, then at the main paths' shapes: B 1, 2, 4, 8, S 1024, 9 heads, kv
    3, head_dim 64, causal, with the LSE. The SIMT kernel over every
    variant at the test shapes (S 256 and 512, GQA rep 2 and 3), in f32
    at head dims 16 and 64 and in bf16 at 24 and 40 (``fwd_route`` sends
    both there). Each
    held to ``tolerance`` (o) and ``close_lse`` (LSE). Timed at the serving
    prefill's shape (B 1, S 1024, causal, bf16, no LSE): both kernels,
    the plain version, SDPA and the bound; the SIMT kernel also in f32."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(6)
    variants = ("causal", "noncausal", "window", "segments")

    def inputs(B, S, H, K, D, Dv, dtype):
        return tuple(torch.randn(sh, generator=gen, device=dev).to(dtype)
                     for sh in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv)))

    def kw_of(variant):
        return dict(causal=variant != "noncausal",
                    window=100 if variant == "window" else 0)

    err_tc, n_tc = 0.0, 0
    for D, Dv in TC_HEAD_DIMS:
        for H, K in ((4, 4), (9, 3)):
            q, k, v = inputs(2, 256, H, K, D, Dv, torch.bfloat16)
            for variant in variants:
                seg = _segments(2, 256, dev, D + H) \
                    if variant == "segments" else None
                err_tc = max(err_tc, _flash_pair(
                    q, k, v, seg, kw_of(variant),
                    f"flash tc {D}/{Dv} {H}/{K} {variant}", "tc"))
                n_tc += 1
    S, H, K, D = 1024, 9, 3, 64
    for B in (1, 2, 4, 8):
        q, k, v = inputs(B, S, H, K, D, D, torch.bfloat16)
        err_tc = max(err_tc, _flash_pair(q, k, v, None, kw_of("causal"),
                                         f"flash tc main shape B{B}", "tc"))
        n_tc += 1
    err_simt, n_simt = 0.0, 0
    for S_ in (256, 512):
        for H_, K_ in ((4, 2), (9, 3)):
            for D_, dtype in ((16, torch.float32), (64, torch.float32),
                              (24, torch.bfloat16), (40, torch.bfloat16)):
                q, k, v = inputs(2, S_, H_, K_, D_, D_, dtype)
                for variant in variants:
                    seg = _segments(2, S_, dev, S_) \
                        if variant == "segments" else None
                    err_simt = max(err_simt, _flash_pair(
                        q, k, v, seg, kw_of(variant),
                        f"flash simt {S_} {H_}/{K_} {D_} {dtype} "
                        f"{variant}", "simt"))
                    n_simt += 1
    torch.cuda.synchronize()
    log(f"flash_attention: tensor-core kernel {n_tc} variants, SIMT kernel "
        f"{n_simt} variants within tolerance (max|err| {err_tc:.3g}, "
        f"{err_simt:.3g})")

    B = 1
    q, k, v = inputs(B, S, H, K, D, D, torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_ref(q, k, v, causal=True)
    err_tc = max(err_tc, close(got, want, "flash main shape"))
    tc_lib, simt_lib = fa._tc_lib(), fa._lib()
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def raw_tc():
        tc_lib.tri_flash_fwd_tc(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                None, o.data_ptr(), None, B, S, H, K, D, D,
                                1, 0, D ** -0.5, stream)

    def raw_simt(x, y, z, out, code):
        simt_lib.tri_flash_fwd(x.data_ptr(), y.data_ptr(), z.data_ptr(),
                               None, out.data_ptr(), None, code, B, S, H, K,
                               D, D, 1, 0, D ** -0.5, stream)

    ms = time_ms(raw_tc, iters=20)
    simt_bf16 = time_ms(lambda: raw_simt(q, k, v, o, 1), iters=20)
    plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v), iters=3)
    lib_ms = time_ms(lambda: _sdpa(q, k, v, is_causal=True), iters=20)
    pairs = B * H * S * (S + 1) / 2            # causal pairs this run needs
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * K * D)
    b_ms, by = bound(nbytes, pairs * 4 * D, bw, tc_rate)
    log(f"flash_attention B{B} S{S} H{H}/K{K} D{D} bf16 causal: tensor-core "
        f"kernel {ms:.4f} ms, SIMT kernel {simt_bf16:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({by})")
    out = {"flash_attention": {
        "max_abs_err": err_tc, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
        "fwd_route": "tc"}}

    # the SIMT kernel at the same shape in f32, the type its route takes
    q32, k32, v32 = (x.float() for x in (q, k, v))
    o32 = torch.empty_like(q32)
    err_simt = max(err_simt, close(
        fa.flash_attention_cuda(q32, k32, v32, causal=True),
        fa.flash_attention_ref(q32, k32, v32, causal=True),
        "flash simt main shape f32"))
    ms32 = time_ms(lambda: raw_simt(q32, k32, v32, o32, 0), iters=10)
    plain32 = time_ms(lambda: fa.flash_attention_ref(q32, k32, v32),
                      iters=3)
    lib32 = time_ms(lambda: _sdpa(q32, k32, v32, is_causal=True), iters=10)
    b32, by32 = bound(2 * nbytes, pairs * 4 * D, bw, f32_ops)
    log(f"flash_attention_simt B{B} S{S} H{H}/K{K} D{D} f32 causal: kernel "
        f"{ms32:.4f} ms, plain {plain32:.4f} ms, sdpa {lib32:.4f} ms, bound "
        f"{b32:.5f} ms ({by32}, f32 outside the tensor cores)")
    out["flash_attention_simt"] = {
        "max_abs_err": err_simt, "ms": ms32, "plain_ms": plain32,
        "bound_ms": b32, "bound_by": by32, "library_ms": lib32,
        "fwd_route": "simt"}
    return out


def _bwd_inputs(B, S, H, K, D, Dv, dtype, dev, gen, seg=None, **kw):
    """q, k, v, dO and the plain forward's (o, lse) for one shape."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = (torch.randn(s, generator=gen, device=dev).to(dtype)
                   for s in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv),
                             (B, S, H, Dv)))
    o, lse = fa.flash_attention_ref(q, k, v, seg, with_lse=True, **kw)
    return q, k, v, do, o, lse


def _bwd_pair(q, k, v, do, o, lse, seg, kw, what):
    """The three backward kernels against their plain versions on the same
    inputs -> (the route ``bwd_route`` gave dQ and dK/dV, max |err| per
    kernel); the launches must be counted on that route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    route = fa.bwd_route(q.dtype, q.shape[-1], v.shape[-1])
    before = dict(ops.LAUNCHES)
    delta = ops.flash_bwd_delta(o, do)
    delta_r = fa.flash_bwd_delta_ref(o, do)
    dq = ops.flash_bwd_dq(q, k, v, do, lse, delta_r, seg, **kw)
    dq_r = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta_r, seg, **kw)
    dk, dv = ops.flash_bwd_dkv(q, k, v, do, lse, delta_r, seg, **kw)
    dk_r, dv_r = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta_r, seg, **kw)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        check(ops.LAUNCHES[f"{name}_{route}"] == before[f"{name}_{route}"] + 1,
              f"{what}: {name} on the {route} route")
    return route, {"delta": close(delta, delta_r, what + " delta"),
                   "dq": close(dq, dq_r, what + " dq"),
                   "dkv": max(close(dk, dk_r, what + " dk"),
                              close(dv, dv_r, what + " dv"))}


def _simt_raw(q, k, v, do, o, lse, seg, kw, what):
    """The SIMT dQ and dK/dV through their raw entry (``tri_flash_bwd_dq``
    / ``tri_flash_bwd_dkv``, whatever ``bwd_route`` picks for these inputs:
    f32 callers now get the split-TF32 kernels) against their plain
    versions on the same inputs -> max |err| (dq, dk/dv)."""
    from repro_torch.kernels import flash_attention as fa
    B, S, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    delta = fa.flash_bwd_delta_ref(o, do)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    ins = tuple(x.data_ptr() for x in (q, k, v, do, lse, delta)) + (
        None if seg is None else seg.data_ptr(),)
    dims = (fa._DTYPE_CODE[q.dtype], B, S, H, K, D, Dv, int(kw["causal"]),
            int(kw["window"]), D ** -0.5, fa.bwd_rows(D, Dv))
    lib, stream = fa._bwd_lib(), torch.cuda.current_stream().cuda_stream
    check(lib.tri_flash_bwd_dq(*ins, dq.data_ptr(), *dims, stream) == 0,
          f"{what}: SIMT dq launched")
    check(lib.tri_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *dims,
                                stream) == 0, f"{what}: SIMT dk/dv launched")
    torch.cuda.synchronize()
    dk_r, dv_r = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, seg, **kw)
    return (close(dq, fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, seg, **kw),
                  what + " simt dq"),
            max(close(dk, dk_r, what + " simt dk"),
                close(dv, dv_r, what + " simt dv")))


def _lm_rungs():
    return [int(r) for r in
            LM_TRAIN_ARGS[LM_TRAIN_ARGS.index("--rungs") + 1].split(",")]


BWD_VARIANTS = ("causal", "noncausal", "window", "segments")


def check_flash_bwd(dev, bw, f32_ops, tc_rate, tf32_rate):
    """The three backward kernels (delta, dQ, dK/dV) against their plain
    versions, each fed the same (q, k, v, dO, o, lse, delta), within
    ``flash_attention.tolerance`` (1e-5 of the largest magnitude plus 1e-5
    relative, and one bf16 ulp in bf16: the sums run in another order, the
    SIMT kernels contract a*b+c, the tensor-core kernels carry P and dS as
    bf16 hi + lo, the split-TF32 kernels every operand as tf32 hi + lo).
    Through the route (``flash_attention.bwd_route``): every bf16 variant
    at the tensor-core head dims takes the tensor-core dQ and dK/dV, every
    f32 variant the split-TF32 ones, and bf16 at head dims 24/64 and 64/40
    the SIMT ones; the launches are counted on that route. Every f32
    variant also runs the SIMT dQ and dK/dV through their raw entry, held
    to the same plain versions; ``bwd_tf32_smem`` must equal the source's
    own size at every head dim the split-TF32 route takes. Over every
    variant (causal, not causal, window, segments): S 256 and 512, GQA rep
    2 and 3, head dims 16 and 64 and two Dv != D, f32 and bf16; then at
    the wide head dims (192, 192),
    (256, 256) and (192, 128) (the SIMT and split-TF32 kernels on 32-row
    tiles, ``flash_attention.bwd_rows``), S 256, 4/2 heads. Then at the LM
    training path's shapes, B = each rung (2, 4, 8), S 1024, 9/3 heads,
    head_dim 64, bf16, causal: the forward kernel with its LSE output (as
    the autograd Function runs it; the tensor-core route) against the
    plain forward's (o, lse), and the three backward kernels. At the top
    rung all are timed: the forward (its SIMT kernel beside it), delta,
    and dQ and dK/dV on the tensor cores beside the SIMT kernels on the
    same bf16 inputs (the route bf16 took before); then in f32 at the same
    shape the split-TF32 dQ and dK/dV (f32's route) and the SIMT ones
    (the route f32 took before), in turns, each row with its bound: the
    split-TF32 rows at the TF32 tensor-core rate for three products a
    product, the f32-FMA bound beside it. The library yardstick for the
    backward rows is the backward of ``scaled_dot_product_attention`` at
    that shape and type (``torch.autograd.grad`` from a saved forward),
    one time for the rows; for the forward row, its forward."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(8)
    err = {r: {"delta": 0.0, "dq": 0.0, "dkv": 0.0}
           for r in ("tc", "tf32", "simt")}
    tf32 = fa._tf32_bwd_lib()
    dims8 = range(8, 257, 8)
    off = [(name, D, Dv) for kern, name in enumerate(("dq", "dkv"))
           for D in dims8 for Dv in dims8
           if tf32.tri_flash_bwd_tf32_smem(kern, D, Dv, fa.bwd_rows(D, Dv))
           != fa.bwd_tf32_smem(name, D, Dv)]
    check(not off, f"bwd_tf32_smem mirrors the split-TF32 source: {off[:4]}")

    def run(S, H, K, D, Dv, dtype, variant, what):
        seg = _segments(2, S, dev, S) if variant == "segments" else None
        kw = dict(causal=variant != "noncausal",
                  window=100 if variant == "window" else 0)
        ins = _bwd_inputs(2, S, H, K, D, Dv, dtype, dev, gen, seg, **kw)
        what = f"flash bwd {what} {dtype} {variant}"
        route, got = _bwd_pair(*ins, seg, kw, what)
        want = ("tf32" if dtype == torch.float32 else
                "tc" if fa.fwd_route(dtype, D, Dv) == "tc" else "simt")
        check(route == want, f"{what}: route {route}")
        err[route] = {k: max(e, got[k]) for k, e in err[route].items()}
        if dtype == torch.float32:      # the SIMT kernels, held all the same
            e_dq, e_dkv = _simt_raw(*ins, seg, kw, what)
            err["simt"]["dq"] = max(err["simt"]["dq"], e_dq)
            err["simt"]["dkv"] = max(err["simt"]["dkv"], e_dkv)
        return route

    def summary(routes):
        return "; ".join(
            f"{routes.count(r)} on the {r} route (max|err| delta "
            f"{err[r]['delta']:.3g}, dq {err[r]['dq']:.3g}, dk/dv "
            f"{err[r]['dkv']:.3g})" for r in ("tc", "tf32", "simt")) + (
            f"; the SIMT kernels through their raw entry on each f32 "
            f"variant, max|err| dq {err['simt']['dq']:.3g}, dk/dv "
            f"{err['simt']['dkv']:.3g}")

    shapes = [(S, hk, D, D) for S in (256, 512) for hk in ((4, 2), (9, 3))
              for D in (16, 64)] + [(256, (9, 3), 64, 32),
                                    (256, (4, 2), 32, 64)]
    routes = [run(S, H, K, D, Dv, dtype, variant, f"{S} {H}/{K} {D}/{Dv}")
              for S, (H, K), D, Dv in shapes
              for dtype in (torch.float32, torch.bfloat16)
              for variant in BWD_VARIANTS]
    # bf16 at head dims the tensor-core kernels refuse: the SIMT route
    routes += [run(256, H, K, D, Dv, torch.bfloat16, variant,
                   f"256 {H}/{K} {D}/{Dv}")
               for (H, K), D, Dv in (((4, 2), 24, 64), ((9, 3), 64, 40))
               for variant in BWD_VARIANTS]
    log(f"flash_attention backward: {len(routes)} variants within "
        f"tolerance, {summary(routes)}")
    wide = []
    for D, Dv in ((192, 192), (256, 256), (192, 128)):
        check(fa.bwd_rows(D, Dv) == 32,
              "SIMT and split TF32: 32-row tiles above head dim 128")
        wide += [run(256, 4, 2, D, Dv, dtype, variant, f"{D}/{Dv}")
                 for dtype in (torch.float32, torch.bfloat16)
                 for variant in BWD_VARIANTS]
    log(f"flash_attention backward at head dims (192, 192), (256, 256), "
        f"(192, 128): {len(wide)} variants within tolerance, "
        f"{summary(wide)}")
    time_wide_heads(dev, gen, bw, tc_rate)

    S, H, K, D = 1024, 9, 3, 64
    kw = dict(causal=True, window=0)
    err_fwd = 0.0
    for B in _lm_rungs():
        q, k, v, do, o, lse = _bwd_inputs(B, S, H, K, D, D, torch.bfloat16,
                                          dev, gen, **kw)
        what = f"flash train shape B{B}"
        o_k, lse_k = fa.flash_attention_cuda(q, k, v, None, with_lse=True,
                                             **kw)
        err_fwd = max(err_fwd, close(o_k, o, what + " fwd"))
        close_lse(lse_k, lse, what + " fwd")
        route, got = _bwd_pair(q, k, v, do, o, lse, None, kw, what + " bwd")
        check(route == "tc", f"{what}: the tensor-core backward")
        err["tc"] = {key: max(e, got[key]) for key, e in err["tc"].items()}
    log(f"flash_attention forward (with LSE) and backward at the training "
        f"rungs {_lm_rungs()}: within tolerance (max|err| fwd "
        f"{err_fwd:.3g}; tensor-core route: delta {err['tc']['delta']:.3g}, "
        f"dq {err['tc']['dq']:.3g}, dk/dv {err['tc']['dkv']:.3g})")
    # timed at the top rung: the inputs of the loop's last pass
    lib, tc_bwd = fa._bwd_lib(), fa._tc_bwd_lib()
    stream = torch.cuda.current_stream().cuda_stream
    tc_lib, simt_lib = fa._tc_lib(), fa._lib()
    o_t, lse_t = torch.empty_like(o), torch.empty_like(lse)
    check(fa.fwd_route(q.dtype, D, D) == "tc", "the training path's route")

    def raw_fwd():
        tc_lib.tri_flash_fwd_tc(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                None, o_t.data_ptr(), lse_t.data_ptr(), B,
                                S, H, K, D, D, 1, 0, D ** -0.5, stream)

    def raw_simt():
        simt_lib.tri_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               None, o_t.data_ptr(), lse_t.data_ptr(), 1, B,
                               S, H, K, D, D, 1, 0, D ** -0.5, stream)

    pairs = B * H * S * (S + 1) / 2            # causal pairs this run needs

    def work(e):
        """(bytes: each input read once, each output written once; ops) of
        each kernel at this shape, for elements of ``e`` bytes."""
        nq, nkv, nl = B * S * H * D * e, B * S * K * D * e, B * H * S * 4
        return {"fwd": (2 * nq + 2 * nkv + nl, pairs * 4 * D),
                "delta": (2 * nq + nl, 2 * B * S * H * D),
                "dq": (2 * nq + 2 * nkv + 2 * nl + nq, pairs * 2 * (3 * D)),
                "dkv": (2 * nq + 2 * nkv + 2 * nl + 2 * nkv,
                        pairs * 2 * (4 * D))}

    fwd_ms = time_ms(raw_fwd, iters=10)
    simt_ms = time_ms(raw_simt, iters=10)
    fwd_plain = time_ms(lambda: fa.flash_attention_ref(
        q, k, v, None, with_lse=True, **kw), iters=2, reps=3)
    fwd_lib = time_ms(lambda: _sdpa(q, k, v, is_causal=True), iters=10)
    fb_ms, fby = bound(*work(2)["fwd"], bw, tc_rate)
    log(f"flash_attention (with LSE) B{B} S{S} H{H}/K{K} D{D} bf16 causal: "
        f"tensor-core kernel {fwd_ms:.4f} ms, SIMT kernel {simt_ms:.4f} ms, "
        f"plain {fwd_plain:.4f} ms, sdpa {fwd_lib:.4f} ms, bound "
        f"{fb_ms:.5f} ms ({fby})")
    out = {"flash_attention@lm_train": {
        "max_abs_err": err_fwd, "ms": fwd_ms, "plain_ms": fwd_plain,
        "bound_ms": fb_ms, "bound_by": fby, "library_ms": fwd_lib,
        "fwd_route": "tc"}}
    delta = torch.empty((B, H, S), device=dev)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    ptr = lambda t: t.data_ptr()          # noqa: E731
    dims = (B, S, H, K, D, D, 1, 0, D ** -0.5)
    ins = (ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), None)
    dgeo = fa.delta_geometry(H, D, 2)
    raw = {
        "delta": lambda: lib.tri_flash_bwd_delta(
            ptr(o), ptr(do), ptr(delta), 1, B, S, H, D, dgeo.ts, dgeo.lpr,
            stream),
        "dq": lambda: tc_bwd.tri_flash_bwd_dq_tc(*ins, ptr(dq), *dims,
                                                 stream),
        "dkv": lambda: tc_bwd.tri_flash_bwd_dkv_tc(*ins, ptr(dk), ptr(dv),
                                                   *dims, stream),
    }
    simt_bf16 = {   # the SIMT kernels on the same bf16 inputs
        "dq": lambda: lib.tri_flash_bwd_dq(*ins, ptr(dq), 1, *dims,
                                           fa.bwd_rows(D, D), stream),
        "dkv": lambda: lib.tri_flash_bwd_dkv(*ins, ptr(dk), ptr(dv), 1,
                                             *dims, fa.bwd_rows(D, D),
                                             stream),
    }
    plain = {
        "delta": lambda: fa.flash_bwd_delta_ref(o, do),
        "dq": lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw),
        "dkv": lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw),
    }
    lib_ms = _sdpa_bwd_ms(q, k, v, do)
    for key, name in (("delta", "flash_attention_bwd_delta"),
                      ("dq", "flash_attention_bwd_dq"),
                      ("dkv", "flash_attention_bwd_dkv")):
        ms = time_ms(raw[key], iters=10)
        plain_ms = time_ms(plain[key], iters=2, reps=3)
        b_ms, by = bound(*work(2)[key], bw, tc_rate)
        e = max(err["tc"][key], err["simt"][key]) if key == "delta" \
            else err["tc"][key]
        simt = (f", SIMT kernel on the same bf16 inputs "
                f"{time_ms(simt_bf16[key], iters=5):.4f} ms"
                if key in simt_bf16 else "")
        if key == "delta":
            dev_ms = device_ms(raw[key])
            simt += f", device time (profiler) {dev_ms:.5f} ms"
        log(f"{name} B{B} S{S} H{H}/K{K} D{D} bf16 causal: kernel "
            f"{ms:.4f} ms{simt}, plain {plain_ms:.4f} ms, bound {b_ms:.5f} "
            f"ms ({by}), max|err| {e:.3g}")
        out[name] = {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}
        if key != "delta":
            out[name]["bwd_route"] = "tc"
        else:
            out[name]["device_ms"] = dev_ms
    log(f"  sdpa backward (all three together, bf16) {lib_ms:.4f} ms")

    # f32 at the same shape: the split-TF32 kernels (f32's route) and the
    # SIMT kernels (the route f32 took before), timed in turns
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    o32, lse32 = fa.flash_attention_ref(q32, k32, v32, with_lse=True, **kw)
    delta32 = fa.flash_bwd_delta_ref(o32, do32)
    args32 = (q32, k32, v32, do32, lse32, delta32)
    check(fa.bwd_route(torch.float32, D, D) == "tf32", "f32 route")
    e_tf = {"dq": close(fa.flash_bwd_dq_cuda(*args32, **kw),
                        fa.flash_bwd_dq_ref(*args32, **kw),
                        "flash bwd tf32 f32 dq"),
            "dkv": max(close(a_, b_, "flash bwd tf32 f32 dk/dv")
                       for a_, b_ in zip(fa.flash_bwd_dkv_cuda(*args32, **kw),
                                         fa.flash_bwd_dkv_ref(*args32,
                                                              **kw)))}
    e_simt = dict(zip(("dq", "dkv"), _simt_raw(
        q32, k32, v32, do32, o32, lse32, None, kw, "flash bwd simt f32")))
    lib32 = _sdpa_bwd_ms(q32, k32, v32, do32)
    dq32, dk32, dv32 = (torch.empty_like(x) for x in (q32, k32, v32))
    ins32 = tuple(ptr(x) for x in args32) + (None,)
    dims32 = (0,) + dims + (fa.bwd_rows(D, D),)
    raw32 = {
        "tf32": {
            "dq": lambda: tf32.tri_flash_bwd_dq_tf32(*ins32, ptr(dq32),
                                                     *dims32, stream),
            "dkv": lambda: tf32.tri_flash_bwd_dkv_tf32(
                *ins32, ptr(dk32), ptr(dv32), *dims32, stream)},
        "simt": {
            "dq": lambda: lib.tri_flash_bwd_dq(*ins32, ptr(dq32), *dims32,
                                               stream),
            "dkv": lambda: lib.tri_flash_bwd_dkv(*ins32, ptr(dk32),
                                                 ptr(dv32), *dims32,
                                                 stream)}}
    turns = {(r, key): [] for r in raw32 for key in ("dq", "dkv")}
    for order in (("tf32", "simt"), ("simt", "tf32")):
        for r in order:
            for key in ("dq", "dkv"):
                turns[(r, key)].append(time_ms(raw32[r][key], iters=5))
    plain32 = {"dq": time_ms(lambda: fa.flash_bwd_dq_ref(*args32, **kw),
                             iters=2, reps=3),
               "dkv": time_ms(lambda: fa.flash_bwd_dkv_ref(*args32, **kw),
                              iters=2, reps=3)}
    for key in ("dq", "dkv"):
        fma_ms, fma_by = bound(*work(4)[key], bw, f32_ops)
        nbytes, nops = work(4)[key]
        tf_ms, tf_by = bound(nbytes, 3 * nops, bw, tf32_rate)
        for r in ("tf32", "simt"):
            name = f"flash_attention_bwd_{key}_{r}"
            t = turns[(r, key)]
            ms = statistics.median(t)
            e = max(e_tf[key], err["tf32"][key]) if r == "tf32" else max(
                e_simt[key], err["simt"][key])
            b_ms, by = (tf_ms, tf_by) if r == "tf32" else (fma_ms, fma_by)
            log(f"{name} B{B} S{S} H{H}/K{K} D{D} f32 causal: kernel "
                f"{ms:.5f} ms (turns {', '.join(f'{x:.5f}' for x in t)}), "
                f"plain {plain32[key]:.4f} ms, sdpa backward (f32) "
                f"{lib32:.4f} ms, bound {b_ms:.5f} ms ({by}"
                + (", three TF32 products a product at the tensor cores' "
                   f"dense rate; the f32-FMA bound {fma_ms:.5f} ms)"
                   if r == "tf32" else ", f32 outside the tensor cores)")
                + f", max|err| {e:.3g}")
            out[name] = {"max_abs_err": e, "ms": ms,
                         "plain_ms": plain32[key], "bound_ms": b_ms,
                         "bound_by": by, "library_ms": lib32,
                         "bwd_route": r}
            if r == "tf32":
                out[name]["f32_fma_bound_ms"] = fma_ms
    pair = {r: sum(out[f"flash_attention_bwd_{key}_{r}"]["ms"]
                   for key in ("dq", "dkv")) for r in ("tf32", "simt")}
    log(f"  f32 dQ + dK/dV: split TF32 {pair['tf32']:.5f} ms, SIMT "
        f"{pair['simt']:.5f} ms, sdpa backward (f32) {lib32:.4f} ms")
    return out


def _sdpa_bwd_ms(q, k, v, do) -> float:
    """Time of SDPA's whole backward (dq, dk, dv) from a saved causal
    forward at these inputs: the library yardstick of the backward rows."""
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    o_lib = _sdpa(qg, kg, vg, is_causal=True)
    do_t = do.transpose(1, 2)
    return time_ms(lambda: torch.autograd.grad(
        o_lib, (qg, kg, vg), do_t, retain_graph=True), iters=10)


def time_wide_heads(dev, gen, bw, tc_rate, D=256) -> None:
    """Log-only times at a wide-head shape no main path runs yet (gemma3-4b's
    head dim 256; B 1, S 1024, 8/4 heads, bf16, causal): the tensor-core
    forward with LSE, the dQ and dK/dV kernels on both routes (the
    tensor-core kernels; the SIMT kernels on 32-row tiles, the route bf16
    took before), SDPA's forward and backward, and each one's bound."""
    from repro_torch.kernels import flash_attention as fa
    B, S, H, K = 1, 1024, 8, 4
    q, k, v, do, o, lse = _bwd_inputs(B, S, H, K, D, D, torch.bfloat16,
                                      dev, gen)
    delta = fa.flash_bwd_delta_ref(o, do)
    pairs = B * H * S * (S + 1) / 2
    nq, nkv, nl = B * S * H * D * 2, B * S * K * D * 2, B * H * S * 4
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    o_lib = _sdpa(qg, kg, vg, is_causal=True)
    lib, stream = fa._bwd_lib(), torch.cuda.current_stream().cuda_stream
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    ins = tuple(x.data_ptr() for x in (q, k, v, do, lse, delta)) + (None,)
    dims = (1, B, S, H, K, D, D, 1, 0, D ** -0.5, fa.bwd_rows(D, D))
    check(fa.bwd_route(q.dtype, D, D) == "tc", "head dim 256: tensor cores")
    b_dq, b_dkv = (3 * nq + 2 * nkv + 2 * nl, pairs * 6 * D), \
        (2 * nq + 4 * nkv + 2 * nl, pairs * 8 * D)
    times = {
        "forward (tensor cores, LSE)": (
            lambda: fa.flash_attention_cuda(q, k, v, with_lse=True),
            (2 * nq + 2 * nkv + nl, pairs * 4 * D)),
        "dQ (tensor cores)": (
            lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta), b_dq),
        "dK/dV (tensor cores)": (
            lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta), b_dkv),
        "dQ (SIMT, 32-row tiles)": (
            lambda: lib.tri_flash_bwd_dq(*ins, dq.data_ptr(), *dims, stream),
            b_dq),
        "dK/dV (SIMT, 32-row tiles)": (
            lambda: lib.tri_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                                          *dims, stream), b_dkv),
        "sdpa forward": (lambda: _sdpa(q, k, v, is_causal=True), None),
        "sdpa backward": (lambda: torch.autograd.grad(
            o_lib, (qg, kg, vg), do.transpose(1, 2), retain_graph=True),
            None),
    }
    parts = []
    for what, (fn, work) in times.items():
        ms = time_ms(fn, iters=5, reps=3)
        b = f", bound {bound(*work, bw, tc_rate)[0]:.4f}" if work else ""
        parts.append(f"{what} {ms:.4f} ms{b}")
    log(f"  B{B} S{S} H{H}/K{K} D{D} bf16 causal: " + "; ".join(parts))


def check_flash_function(dev) -> dict:
    """The differentiable ``ops.flash_attention`` (forward kernel with LSE,
    then the three backward kernels) against autograd through the plain
    forward in f32 on the same inputs, on the card. In f32 (the SIMT
    forward, the split-TF32 dQ and dK/dV) each gradient within 1e-5 of its
    largest magnitude (the CPU parity test measures 4e-7 between the two
    formulations; the card adds its own summation order). In bf16 (the
    tensor-core routes, forward and backward) within 2^-7 of it: the
    gradients round to bf16 (half an ulp, up to 2^-8 of the largest
    magnitude) and delta is taken from the bf16 o; the same bf16 chain
    through the plain versions stays within it on the CPU
    (``tests/test_torch_flash_bwd_tc.py``), and the kernels add their one
    ulp. Head dim 64, and once 256. The launches are counted on each
    route -> the split-TF32 dQ and dK/dV launches of the f32 backwards."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(9)
    f32_launches = {}
    for dtype, route, bwd, limit in (
            (torch.float32, "simt", "tf32", 1e-5),
            (torch.bfloat16, "tc", "tc", 2.0 ** -7)):
        worst, n = 0.0, 0
        start = dict(ops.LAUNCHES)
        for S, variant, D in ((256, "causal", 64), (256, "segments", 64),
                              (512, "window", 64), (1024, "causal", 64),
                              (256, "causal", 256)):
            B, H, K = 2, 9, 3
            seg = _segments(B, S, dev, S + 1) \
                if variant == "segments" else None
            kw = dict(causal=True, window=100 if variant == "window" else 0)
            q, k, v, do = (torch.randn(s, generator=gen, device=dev).to(dtype)
                           for s in ((B, S, H, D), (B, S, K, D),
                                     (B, S, K, D), (B, S, H, D)))
            ins = [x.requires_grad_(True) for x in (q, k, v)]
            before = dict(ops.LAUNCHES)
            o = ops.flash_attention(*ins, segments=seg, **kw)
            got = torch.autograd.grad(o, ins, do)
            for key in ("flash_attention", f"flash_attention_{route}",
                        "flash_attention_bwd_delta", "flash_attention_bwd_dq",
                        f"flash_attention_bwd_dq_{bwd}",
                        "flash_attention_bwd_dkv",
                        f"flash_attention_bwd_dkv_{bwd}"):
                check(ops.LAUNCHES[key] == before[key] + 1,
                      f"Function launched {key} once ({dtype})")
            ins32 = [x.detach().float().requires_grad_(True) for x in ins]
            want = torch.autograd.grad(
                fa.flash_attention_ref(*ins32, seg, **kw), ins32, do.float())
            torch.cuda.synchronize()
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                gap = float((g.float() - w).abs().max()) / float(
                    w.abs().max())
                check(gap <= limit, f"Function {dtype} {S} {variant} D{D} "
                      f"{name}: {gap}")
                worst = max(worst, gap)
            n += 1
        grew = {k: ops.LAUNCHES[k] - start[k] for k in ops.LAUNCHES
                if ops.LAUNCHES[k] != start[k]}
        log(f"flash_attention Function, {dtype} (forward {route}, backward "
            f"{bwd}): gradients of {n} variants within {worst:.3g} of plain "
            f"autograd in f32 (relative to each gradient's max; limit "
            f"{limit:.3g}); launches {grew}")
        if dtype == torch.float32:
            f32_launches = {f"flash_attention_bwd_{k}_tf32":
                            grew[f"flash_attention_bwd_{k}_tf32"]
                            for k in ("dq", "dkv")}
    return f32_launches


def _decode_inputs(B, L, H, K, D, Dv, dtype, dev, gen):
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, L, K, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, L, K, Dv), generator=gen, device=dev).to(dtype)
    return q, k, v


def check_decode(dev, bw, tc_rate):
    """The split-key decode kernel against its plain version, within
    ``tolerance``, f32 and bf16: lengths 0, 1, L and between, and at the
    edges of the cluster's split (N = ``DECODE_CLUSTER`` blocks: below N,
    N, N + 1, c N +- 1 with c = 17 and 64, L - 1, L; and -5 and L + 9,
    which the kernel clamps) at 9/3 heads of 64 and 4/2 of 16, L 256 and
    2048; (D, Dv) = (64, 32) and (256, 256), rep 1 (2/2 heads), rep * Dv =
    2048 (8/1 heads of 256; a two-stage ring in f32), head dims that are not
    whole 16-byte chunks (20 / 36: plain loads); B 1, 2 and 4 at L 2048
    (the serving rungs). Length 0 gives exact zeros. Then at the main
    path's shape (B 4 against a 2048-slot bf16 cache, live lengths
    1024-1088): a bitwise repeat, the C side's shared memory against
    ``decode_geometry``, the kernel timed beside the plain version, SDPA
    with a length mask and the byte bound, by CUDA events and by the
    profiler's device time (also with every length 0: the fixed cost), and
    the cluster sizes 4, 8, 16 timed beside each other (log only)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(7)
    N = fa.DECODE_CLUSTER
    err, n = 0.0, 0

    def run(B, L, H, K, D, Dv, dtype, lens):
        nonlocal err, n
        q, k, v = _decode_inputs(B, L, H, K, D, Dv, dtype, dev, gen)
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = fa.flash_decode_cuda(q, k, v, lens)
        want = fa.flash_decode_ref(q, k, v, lens)
        what = f"decode B{B} L{L} {H}/{K} ({D}, {Dv}) {dtype}"
        err = max(err, close(got, want, what))
        zero = (lens <= 0).nonzero().flatten().tolist()
        check(all(bool((got[i] == 0).all()) for i in zero),
              f"{what}: length 0 gives 0")
        n += 1

    for dtype in (torch.float32, torch.bfloat16):
        for (H, K), D, L in (((4, 2), 16, 256), ((9, 3), 64, 256),
                             ((9, 3), 64, 2048)):
            c = [17, 64] if L > 64 * N else [17]
            edges = [0, 1, N - 1, N, N + 1, L - 1, L, 77, L // 2, -5, L + 9]
            edges += [x * N + d for x in c for d in (-1, 1)]
            run(len(edges), L, H, K, D, D, dtype, edges)
        for (H, K), D, Dv, L in (((9, 3), 64, 32, 256), ((4, 2), 256, 256, 256),
                                 ((2, 2), 64, 64, 2048), ((8, 1), 256, 256,
                                                          2048),
                                 ((4, 2), 20, 36, 256)):
            run(6, L, H, K, D, Dv, dtype, [0, 1, L, 77, L // 2 + 3, L - 1])
        for B in (1, 2, 4):
            run(B, 2048, 9, 3, 64, 64, dtype, [1088, 1071, 1040, 1024][:B])
    check(fa.decode_geometry(2048, 8, 256, 256, 4).stages == 2,
          "rep * Dv 2048 in f32 runs a two-stage ring")
    log(f"flash_decode: {n} variants within tolerance (max|err| {err:.3g}), "
        f"cluster of {N}")

    B, L, H, K, D = 4, 2048, 9, 3, 64
    q, k, v = _decode_inputs(B, L, H, K, D, D, torch.bfloat16, dev, gen)
    lens = torch.tensor([1088, 1071, 1040, 1024], dtype=torch.int32,
                        device=dev)
    got = ops.flash_decode(q, k, v, lens)
    want = fa.flash_decode_ref(q, k, v, lens)
    err = max(err, close(got, want, "decode main shape"))
    again = ops.flash_decode(q, k, v, lens)
    check(same(got, again), "decode main shape: a bitwise repeat")
    lib = fa._decode_lib()
    geo = fa.decode_geometry(L, H // K, D, D, 2)
    check(lib.tri_flash_decode_smem(1, L, H, K, D, D, geo.cluster, geo.tk,
                                    geo.stages, geo.lpr) == geo.smem,
          "decode shared memory: C and decode_geometry agree")
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def raw(cluster=N, lens=lens):
        g = fa.decode_geometry(L, H // K, D, D, 2, cluster)
        return lambda: lib.tri_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            o.data_ptr(), 1, B, L, H, K, D, D, D ** -0.5, g.cluster, g.tk,
            g.stages, g.lpr, stream)

    sweep = {}
    for cluster in (4, 8, 16):
        check(raw(cluster)() == 0, f"decode launch, cluster {cluster}")
        torch.cuda.synchronize()
        close(o, want, f"decode main shape, cluster {cluster}")
        sweep[cluster] = time_ms(raw(cluster), iters=50)
    ms = time_ms(raw(), iters=50)
    dev_ms = device_ms(raw())
    # the fixed cost: every row of length 0 (launch, length read, barrier,
    # combine and write; no key loaded)
    floor_ms = device_ms(raw(lens=torch.zeros_like(lens)))
    plain_ms = time_ms(lambda: fa.flash_decode_ref(q, k, v, lens), iters=5)
    mask = (torch.arange(L, device=dev)[None, :] < lens[:, None]
            ).reshape(B, 1, 1, L)
    lib_ms = time_ms(lambda: _sdpa(q, k, v, attn_mask=mask), iters=50)
    lib_dev_ms = device_ms(lambda: _sdpa(q, k, v, attn_mask=mask))
    live = int(lens.sum())
    nbytes = 2 * (2 * B * H * D + 2 * live * K * D) + 4 * B
    b_ms, by = bound(nbytes, live * H * 4 * D, bw, tc_rate)
    log(f"flash_decode B{B} L{L} H{H}/K{K} D{D} bf16, live {lens.tolist()}: "
        f"kernel {ms:.5f} ms (cluster {N}; by cluster size "
        + ", ".join(f"{c}: {t:.5f}" for c, t in sweep.items())
        + f"), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({by}); device time (profiler) kernel "
        f"{dev_ms:.5f} ms (every length 0: {floor_ms:.5f} ms), sdpa "
        f"{lib_dev_ms:.5f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms}


def check_delta(dev) -> float:
    """delta against its plain version, within ``tolerance``, and a bitwise
    repeat of each call: Dv 16, 40, 64, 128 and 256 (and 36, whose bf16
    rows are not whole 16-byte chunks: the scalar tail) in f32 and bf16 at
    B 2, S 1024, 9 heads; S 1000 (a partial last block) at Dv 64 in bf16;
    then the LM rungs (B 2, 4, 8, S 1024, 9 heads, Dv 64, bf16). -> max
    |err|."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(10)
    err, n = 0.0, 0
    cases = [(2, 1024, Dv, dt) for Dv in (16, 36, 40, 64, 128, 256)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 1000, 64, torch.bfloat16)]
    cases += [(B, 1024, 64, torch.bfloat16) for B in _lm_rungs()]
    for B, S, Dv, dtype in cases:
        o, do = (torch.randn((B, S, 9, Dv), generator=gen, device=dev
                             ).to(dtype) for _ in range(2))
        got = ops.flash_bwd_delta(o, do)
        what = f"delta B{B} S{S} Dv{Dv} {dtype}"
        err = max(err, close(got, fa.flash_bwd_delta_ref(o, do), what))
        check(same(got, ops.flash_bwd_delta(o, do)), f"{what}: bitwise repeat")
        n += 1
    log(f"flash_attention_bwd_delta: {n} variants within tolerance and "
        f"repeating bitwise (max|err| {err:.3g})")
    return err


# ------------------------------- phase 4b: LM serving, card vs CPU ---
def _lm_cfg(layers: int):
    """smollm-135m at full width, cut to ``layers`` layers."""
    import dataclasses
    from repro_torch.configs import smollm_135m
    cfg = smollm_135m.config()
    seg = ((cfg.stack.segments[0][0], layers),)
    return dataclasses.replace(cfg, stack=dataclasses.replace(
        cfg.stack, segments=seg))


def check_lm_against_cpu(layers: int = 2, prompt: int = 1024,
                         total: int = 2048, steps: int = 4):
    """One prefill plus ``steps`` teacher-forced decode steps of
    smollm-135m at full width and ``layers`` layers, bf16 weights from one
    seeded init, on the card (kernels) and on the CPU (plain versions).
    Logits within 4 % of their largest magnitude (the bf16 rounding spread
    the CPU parity test sees against the reference,
    tests/test_torch_lm_serve.py), greedy tokens reported."""
    from repro_torch import tree as tu
    from repro_torch.models import lm
    from repro_torch.serve.engine import scatter_prefill
    cfg = _lm_cfg(layers)
    params = lm.lm_init(torch.Generator().manual_seed(3), cfg)
    params = tu.tree_map(lambda x: x.to(torch.bfloat16), params)
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g,
                         dtype=torch.int32)
    feed = torch.randint(0, cfg.vocab_size, (steps, 1), generator=g,
                         dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tu.tree_map(lambda x: x.to(dev), params)
        logits = []
        with torch.no_grad():
            lg, pre = lm.lm_prefill(p, {"tokens": toks.to(dev)}, cfg)
            logits.append(lg.float().cpu())
            caches = scatter_prefill(
                lm.lm_init_cache(cfg, 1, total, device=dev), pre, 0)
            for i in range(steps):
                lg, caches = lm.lm_decode_step(
                    p, feed[i].to(dev), caches,
                    torch.tensor([prompt + i], device=dev), cfg)
                logits.append(lg.float().cpu())
        out[dev] = torch.stack(logits)
    ref, got = out["cpu"], out["cuda"]
    gap = float((got - ref).abs().max())
    lim = 0.04 * float(ref.abs().max())
    same_top = (got.argmax(-1) == ref.argmax(-1)).float().mean()
    log(f"smollm-135m x{layers} layers, prefill {prompt} + {steps} decode "
        f"steps, card vs CPU: max|dlogit| {gap:.4g} (limit {lim:.4g}, max "
        f"|logit| {float(ref.abs().max()):.4g}), same argmax "
        f"{float(same_top):.2f}")
    check(bool(torch.isfinite(got).all()), "finite logits on the card")
    check(gap <= lim, f"card vs CPU logits {gap} > {lim}")


# ------------------------------ phase 4c: LM train step, card vs CPU ---
def check_lm_step_against_cpu(layers: int = 2, seq: int = 1024,
                              batch: int = 2):
    """One slab-resident train step of smollm-135m at full width and
    ``layers`` layers, S 1024, B 2, on the card (kernels, cuBLAS bf16
    matmuls) and on the CPU (plain versions), from the same init and
    batch. The model computes in bf16, so the two differ by bf16 roundings
    taken after sums in other orders (the CPU parity test against the
    reference measures up to 1.2e-2 of a leaf's largest gradient,
    tests/test_torch_lm_train.py): the momentum (the clipped gradient) is
    held leaf by leaf within 5e-2 of the leaf's largest magnitude, and what
    follows from it by the update's arithmetic:
      master   p_card - p_cpu = -lr * (m_card - m_cpu), up to 2^-21 (|p| +
               |p'_card| + |p'_cpu|): each side rounds once, relative to
               its own magnitudes
      copy     within the masters' gap plus half a bf16 step of each
    loss within rtol 1e-3, codes equal."""
    from repro_torch.core.precision import TriAccelConfig
    from repro_torch.data.synthetic import LMTaskStream
    from repro_torch.train.task import LMTask
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = _lm_cfg(layers)
    tac = TriAccelConfig(ladder="gpu", t_ctrl=1, curvature_method="fisher")
    tcfg = TrainerConfig(total_steps=10, base_lr=0.05, warmup_steps=2,
                         grad_clip=1.0, rungs=(batch,), seq_len=seq)
    data = LMTaskStream(cfg.vocab_size, seq, batch, seed=3).batch(0)
    out = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(LMTask(cfg, device=dev), tac, tcfg, device=dev)
        b = {k: v.to(dev) for k, v in data.items()}
        st, met = tr._step_fn(tr.state, b)
        out[dev] = (tr.state.params.cpu(), st, met)
    view = tr.view
    (p0, sc, mc), (_, sg, mg) = out["cpu"], out["cuda"]
    cpu = lambda t: t.detach().cpu().float()     # noqa: E731
    check(bool(mg["grads_finite"]) and bool(torch.isfinite(mg["loss"])),
          "finite LM step on the card")
    torch.testing.assert_close(cpu(mg["loss"]), mc["loss"], rtol=1e-3,
                               atol=0)
    mo_g, mo_c = cpu(sg.opt_state["mu"]), sc.opt_state["mu"]
    worst = 0.0
    for slot in view.slots:
        rows = slice(slot.row_off, slot.row_off + slot.stack * slot.rows_per)
        gap = float((mo_g[rows] - mo_c[rows]).abs().max())
        worst = max(worst, gap / float(mo_c[rows].abs().max()))
    check(worst <= 5e-2, f"card vs CPU clipped LM gradient: {worst}")
    lr = float(mc["lr"])
    check(float(mg["lr"]) == lr, "learning rate")
    p_g, p_c = cpu(sg.params), sc.params
    # each side rounds p - lr * m once, relative to its own magnitudes: a
    # bf16 gradient entry near zero may be many times larger on one side
    dev_p = ((p_g - p_c) + lr * (mo_g - mo_c)).abs()
    lim_p = 2.0 ** -21 * (p0.abs() + p_c.abs() + p_g.abs())
    w = int(torch.argmax(dev_p - lim_p))
    check(bool((dev_p <= lim_p).all()),
          f"master = p - lr * m on both devices: at {w} p0 "
          f"{float(p0.flatten()[w])!r} p {float(p_g.flatten()[w])!r} / "
          f"{float(p_c.flatten()[w])!r} m {float(mo_g.flatten()[w])!r} / "
          f"{float(mo_c.flatten()[w])!r} lr {lr!r}")
    cp_g, cp_c = cpu(sg.compute["slab"]), sc.compute["slab"].float()
    lim = (p_g - p_c).abs() + 2.0 ** -8 * (p_g.abs() + p_c.abs()) + 2.0 ** -24
    check(bool(((cp_g - cp_c).abs() <= lim).all()), "LM compute copy")
    check(torch.equal(sg.control.codes.cpu(), sc.control.codes), "codes")
    check_layer_views_gradient(tr, {k: v.cuda() for k, v in data.items()})
    log(f"smollm-135m x{layers} layers, one train step at S {seq}, B "
        f"{batch}, card vs CPU: loss {float(mg['loss']):.6f} vs "
        f"{float(mc['loss']):.6f}; momentum (the clipped gradient) within "
        f"{worst:.3g} of each leaf's max; max|dmaster| "
        f"{float((p_g - p_c).abs().max()):.3g}; codes "
        f"{sg.control.codes.tolist()}")


def check_layer_views_gradient(tr, batch) -> None:
    """The stack takes its per-layer views with one ``torch.unbind`` per
    stacked leaf, whose backward stacks the layers' gradients once; the
    gradient of the compute slab must equal, bitwise, the one through
    per-layer indexing ``x[i]`` (whose backward adds a zero tensor the
    size of the stack per layer). Peak bytes of both are reported."""
    from repro_torch import tree as tu
    from repro_torch.core.batch_scaler import measured_peak_bytes
    from repro_torch.nn import blocks

    def slab_grad():
        wrt = tr.state.compute["slab"].detach().requires_grad_(True)
        cp = tr.view.unpack(wrt, like=tr._params_like)
        total = tr.task.loss(cp, {}, batch, None, None)[0]
        return torch.autograd.grad(total, wrt)[0]

    g_unbind, peak_unbind = measured_peak_bytes(slab_grad, "cuda")
    unbind = blocks._layers
    blocks._layers = lambda tree, n: [tu.tree_map(lambda x: x[i], tree)
                                      for i in range(n)]
    try:
        g_index, peak_index = measured_peak_bytes(slab_grad, "cuda")
    finally:
        blocks._layers = unbind
    check(torch.equal(g_unbind, g_index),
          "slab gradient through unbind equals the one through indexing")
    log(f"  slab gradient through per-layer unbind == through indexing, "
        f"bitwise; peak allocated {peak_unbind / 1e9:.3f} GB vs "
        f"{peak_index / 1e9:.3f} GB")


# --------------------------------- phase 5c: the LM training main path ---
def lm_train_main_path():
    """The LM training main path through the launcher:
    ``launch.train.main(LM_TRAIN_ARGS)`` (smollm-135m at 30 layers and
    published widths, S 1024, rungs 2/4/8, 20 steps, sgdm, gpu ladder,
    fisher curvature on b_curv-sized batches) with t_ctrl / t_curv lowered
    to 5 / 10. The launch counts must equal what the code implies: with
    remat each layer runs the forward kernel twice a step (forward, and the
    recompute in backward) and each backward kernel once; the fisher probe
    runs under ``flash_fallback`` and launches none; an OOM retry would
    re-run a step (none may happen at this size)."""
    import io
    import warnings
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ops.WARNED_FALLBACKS.clear()
    printed = io.StringIO()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed), signals_kept():
            tr = launch_train.main(LM_TRAIN_ARGS, t_ctrl=LM_T_CTRL,
                                   t_curv=LM_T_CURV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    steps = int(LM_TRAIN_ARGS[LM_TRAIN_ARGS.index("--steps") + 1])
    L = tr.task.cfg.num_layers
    fallbacks = [str(w.message) for w in caught
                 if "kernel gate failed" in str(w.message)]
    check(not fallbacks and not ops.WARNED_FALLBACKS,
          f"fallback warnings on the LM training path: {fallbacks}")
    check(not tr.oom_events, f"OOM events {tr.oom_events}")
    check(int(tr.state.control.step) == steps, "all steps taken")
    lines = [json.loads(x) for x in printed.getvalue().splitlines()]
    check(len(lines) == len(tr.metrics_log) == -(-steps // 10),
          f"{len(lines)} JSON lines")
    check(all(math.isfinite(m["loss"]) for m in lines), f"losses {lines}")
    want = {"flash_attention": 2 * L * steps,
            "flash_attention_tc": 2 * L * steps, "flash_attention_simt": 0,
            "flash_attention_bwd_delta": L * steps,
            "flash_attention_bwd_dq": L * steps,
            "flash_attention_bwd_dq_tc": L * steps,
            "flash_attention_bwd_dq_tf32": 0,
            "flash_attention_bwd_dq_simt": 0,
            "flash_attention_bwd_dkv": L * steps,
            "flash_attention_bwd_dkv_tc": L * steps,
            "flash_attention_bwd_dkv_tf32": 0,
            "flash_attention_bwd_dkv_simt": 0,
            "fused_stats": steps, "fused_apply": steps}
    for k, n in want.items():
        check(launches[k] == n, f"{k}: {launches[k]} launches, expected {n}")
    var, view = lm_train_variant(), lm_train_view()
    check(tr.view.rows == view.rows and tr.view.num_layers ==
          view.num_layers, "the LM slab the fused kernels were checked on")
    check(tr.opt.spec == var["spec"] and tr.tac.ladder == var["ladder"]
          and tr.tac.stochastic_round == var["sr"]
          and tr.task.compute_dtype == var["cp_dtype"]
          and tr.state.compute["slab"].dtype == var["g_dtype"],
          "the fused update variant the kernels were checked on")
    lam = tr.state.control.lam
    check(float(lam.abs().sum()) > 0, "fisher curvature refreshed")
    check(len(tr.scaler.history) == (steps - 1) // LM_T_CTRL,
          f"rung controller every {LM_T_CTRL} steps")
    log(f"LM training main path: launch.train.main({' '.join(LM_TRAIN_ARGS)})"
        f" with t_ctrl {LM_T_CTRL}, t_curv {LM_T_CURV}: {steps} steps in "
        f"{wall:.2f} s (init included), {L} layers, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    log(f"  logged loss {[round(m['loss'], 4) for m in lines]} at steps "
        f"{[m['step'] for m in lines]}, finite steps all {steps}")
    log(f"  rung history {tr.scaler.history}, measured peak bytes per rung "
        f"{ {k: int(v) for k, v in tr.measured_bytes.items()} }")
    log(f"  codes {tr.state.control.codes.tolist()}, fisher curvature per "
        f"layer {[float(f'{x:.3g}') for x in lam.tolist()]}")
    log(f"  launches {launches}")
    return tr, launches, lm_serving_set(tr)


def lm_serving_set(tr) -> int:
    """The one-pass form's path, at the end of the LM training path: the
    tier-0 serving weight set built from the trained masters with the
    trainer's absmax table (``Trainer.serving_amax_tree``, from the fused
    step's carried per-layer ``p_amax``), as ``ServeEngine(amax_tree=...)``
    builds it: one one-pass launch a leaf, bf16 written directly. Each
    amax must bound its leaf's absmax of the bf16-cast master, and each
    leaf equal the plain version with the same amax, bitwise. -> the
    one-pass launches."""
    from repro_torch import tree as tu
    from repro_torch.kernels import ops
    from repro_torch.kernels import qdq_cast as qc
    from repro_torch.serve.engine import tier_params
    bf = torch.bfloat16
    params = tr.params_tree()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    amax_tree = tr.serving_amax_tree()
    w0 = tier_params(params, 0, "tpu", amax_tree=amax_tree)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    leaves, amaxes = tu.leaves(params), tu.leaves(amax_tree)
    check(launches["qdq_cast_one_pass"] == launches["qdq_cast"]
          == len(leaves) == len(_lm_leaves())
          and launches["qdq_cast_two_pass"] == 0,
          f"one one-pass launch a leaf: {launches}")
    for leaf, a, w in zip(leaves, amaxes, tu.leaves(w0)):
        what = f"tier-0 leaf {tuple(leaf.shape)} from the table"
        true = leaf.to(bf).float().abs().max()
        check(float(a) >= float(true), f"{what}: amax {float(a)} bounds "
              f"{float(true)}")
        want = qc.qdq_cast_ref(leaf.float(), 0, "tpu", a, out_dtype=bf)
        check(w.dtype == bf and same(w, want), what)
        check(bool(torch.isfinite(w).all()), f"{what} finite")
    log(f"LM tier-0 serving set from Trainer.serving_amax_tree: "
        f"{len(leaves)} leaves in {wall * 1e3:.2f} ms (table included), "
        f"bitwise equal to the plain version; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches["qdq_cast_one_pass"]


def time_lm_rungs(tr, per_rung: int = 6):
    """Median step time per rung of the main path's trainer: each rung in
    turn for ``per_rung`` steps, host wall time of each step ending in a
    device sync. Each rung's first step (which also measures the rung's
    peak bytes if it is new) and steps that refresh the fisher curvature
    are left out."""
    out = {}
    for i, rung in enumerate(tr.scaler.rungs):
        times = []
        for j in range(per_rung):
            tr.scaler.idx = i
            step = int(tr.state.control.step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run(1)
            torch.cuda.synchronize()
            if j and step % tr.tac.t_curv:   # not the rung's first step
                times.append((time.perf_counter() - t0) * 1e3)
        out[rung] = statistics.median(times)
    peaks_b = {k: int(v) for k, v in tr.measured_bytes.items()}
    log(f"LM step time by rung (median ms, {per_rung} steps a rung): "
        f"{ {r: round(ms, 3) for r, ms in out.items()} }; measured peak "
        f"bytes per rung {peaks_b}")
    return out


def profile_lm_step(tr) -> None:
    """Where an LM train step's time goes: one step at the top rung."""
    tr.scaler.idx = len(tr.scaler.rungs) - 1
    if int(tr.state.control.step) % tr.tac.t_curv == 0:
        tr.run(1)                       # keep the fisher probe out

    def family(n):
        if "bwd_dq_tc_kernel" in n or "bwd_dkv_tc_kernel" in n:
            return "flash backward dQ, dK/dV (this port's tensor-core kernels)"
        if "delta_kernel" in n:
            return "flash backward delta (this port's kernel)"
        if "dq_kernel" in n or "dkv_kernel" in n:
            return "flash backward SIMT dQ, dK/dV (this port's kernels)"
        if "fwd_tc_kernel" in n:
            return "flash forward (this port's tensor-core kernel)"
        if "fwd_kernel" in n:
            return "flash forward (this port's SIMT kernel)"
        if "stats_partials" in n or "apply_kernel" in n \
                or "reduce_partials" in n:
            return "fused update (this port's kernels)"
        if any(w in n for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                                "sm90", "splitk")):
            return "matmul (projections, FFN, readout; cuBLAS)"
        if "memcpy" in n or "memset" in n or "copy" in n:
            return "casts and copies"
        if "reduce" in n:
            return "reduction (norms, logsumexp, sums)"
        return "elementwise (RoPE, norms, SiLU, softmax-xent, residuals)"

    _profile(lambda: tr.run(1), 1, family,
             f"1 LM train step at rung {tr.scaler.microbatch}")


# ------------------------ phase 5d: the reference training main paths ---
#: the paper's FP32 baseline through the harness, and the static-AMP
#: baseline through the launcher (smollm-135m at 30 layers, S 1024, rung 8)
FP32_ARGS = dict(steps=20, batch0=32)
NO_TRIACCEL_ARGS = ["--arch", "smollm-135m", "--seq", "1024", "--rungs", "8",
                    "--steps", "10", "--ladder", "gpu", "--no-triaccel"]


def _step_ms(tr, steps: int = 5) -> float:
    """Median host time of ``steps`` more train steps of ``tr``, each
    ending in a device sync."""
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fp32_main_path(arch: str = "resnet18", name: str = "ResNet-18",
                   bw=None, f32_ops=None):
    """``run_method("fp32", arch, steps=20, batch0=32)``: the reference
    step over tree-form state, no fused-update launch, codes reported as
    fp32, the rung fixed at 32. Then the port's path to ``grad_stats``:
    its op over the gradient tree of the same trainer's first step
    (``make_trainer`` builds the trainer ``run_method`` runs), timed over
    the whole tree when ``bw`` is given -> (that path's result, median step
    ms, peak bytes)."""
    from repro_torch.kernels import ops
    from repro_torch.train.paper_harness import make_trainer, run_method
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run_method("fp32", arch, device="cuda", **FP32_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps, batch0 = FP32_ARGS["steps"], FP32_ARGS["batch0"]
    losses = [m["loss"] for m in res.log]
    check(len(res.log) == steps and all(
        math.isfinite(x) and m["grads_finite"] == 1.0
        for x, m in zip(losses, res.log)), f"fp32 losses {losses}")
    check(sum(launches.values()) == 0, f"fp32 launches {launches}")
    check(res.codes == [2] * len(res.codes), f"fp32 codes {res.codes}")
    check(res.final_batch == batch0 and res.batch_history == []
          and all(m["rung"] == batch0 for m in res.log), "rung fixed")
    walls = [m["wall_s"] for m in res.log]
    step_ms = statistics.median(b - a for a, b in zip(walls[4:], walls[5:]))
    log(f"FP32 main path: run_method('fp32', '{arch}', steps={steps}, "
        f"batch0={batch0}) in {wall:.2f} s (eval included): median step "
        f"{step_ms * 1e3:.3f} ms (steps 5..{steps - 1}), peak allocated "
        f"{peak / 1e9:.3f} GB, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"held-out accuracy {res.accuracy:.2f} %, rung {res.final_batch}, "
        f"codes {res.codes}, launches {launches}")
    tr = make_trainer("fp32", arch, device="cuda", **FP32_ARGS)[0]
    st = tr.state
    return grad_stats_over_gradients(
        name, tr.task, st.params, st.aux_state,
        tr._batch_for_rung(batch0, 0), tr.tac, st.control, bw, f32_ops,
        whole_tree=True), step_ms * 1e3, peak


def no_triaccel_main_path(bw, f32_ops):
    """``launch.train.main(NO_TRIACCEL_ARGS)``: smollm-135m at 30 layers
    and published widths, S 1024, rung 8, the static bf16 baseline on the
    reference step. Launches: the forward kernel 2 x 30 a step (forward
    and remat recompute), each backward kernel 30 a step, no fused update.
    Then the step time, and the port's path to ``grad_stats`` over the
    gradient tree of the trainer's next step (its loss and batch), timed
    on the largest leaf."""
    import io
    import warnings
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ops.WARNED_FALLBACKS.clear()
    printed = io.StringIO()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed), signals_kept():
            tr = launch_train.main(NO_TRIACCEL_ARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = int(NO_TRIACCEL_ARGS[NO_TRIACCEL_ARGS.index("--steps") + 1])
    rung = int(NO_TRIACCEL_ARGS[NO_TRIACCEL_ARGS.index("--rungs") + 1])
    L = tr.task.cfg.num_layers
    fallbacks = [str(w.message) for w in caught
                 if "kernel gate failed" in str(w.message)]
    check(not fallbacks and not ops.WARNED_FALLBACKS,
          f"fallback warnings on the --no-triaccel path: {fallbacks}")
    check(not tr.fused and tr.state.compute == () and not tr.oom_events,
          "the reference step, no OOM")
    check(int(tr.state.control.step) == steps, "all steps taken")
    lines = [json.loads(x) for x in printed.getvalue().splitlines()]
    check(len(lines) == len(tr.metrics_log) == -(-steps // 10) and all(
        math.isfinite(m["loss"]) and m["grads_finite"] == 1.0
        for m in tr.metrics_log), f"logged {lines}")
    want = {"flash_attention": 2 * L * steps,
            "flash_attention_tc": 2 * L * steps,
            "flash_attention_bwd_delta": L * steps,
            "flash_attention_bwd_dq": L * steps,
            "flash_attention_bwd_dq_tc": L * steps,
            "flash_attention_bwd_dkv": L * steps,
            "flash_attention_bwd_dkv_tc": L * steps}
    check({k: v for k, v in launches.items() if v} == want,
          f"--no-triaccel launches {launches}, expected {want}")
    check(tr.scaler.microbatch == rung and tr.scaler.history == [],
          f"rung fixed at {rung}")
    log(f"--no-triaccel main path: launch.train.main("
        f"{' '.join(NO_TRIACCEL_ARGS)}): {steps} steps in {wall:.2f} s "
        f"(init included), {L} layers, peak allocated {peak / 1e9:.3f} GB, "
        f"loss {[round(m['loss'], 4) for m in lines]} at steps "
        f"{[m['step'] for m in lines]}, codes "
        f"{tr.state.control.codes.tolist()}, launches {launches}")
    torch.cuda.reset_peak_memory_stats()
    ms = _step_ms(tr)
    log(f"  step time at rung {rung} (median of 5 more steps) {ms:.3f} "
        f"ms, peak allocated over them "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    profile_lm_step(tr)
    st = tr.state
    out = grad_stats_over_gradients(
        "smollm-135m", tr.task, st.params, st.aux_state,
        tr._batch_for_rung(rung, int(st.control.step)), tr.tac, st.control,
        bw, f32_ops)
    return launches, out


def check_reference_steps_against_cpu():
    """One reference step on the card and on the CPU from the same weights,
    state and batch: ResNet-18 and EfficientNet-B0 at batch 2 (the FP32
    baseline's configuration) and smollm-135m at full width and 2 layers,
    S 1024, B 2 (the --no-triaccel configuration). Bounds as the resident
    steps' (``check_step_against_cpu``, ``check_lm_step_against_cpu``): the
    momentum (the clipped gradient) leaf by leaf within 3e-2 (the vision
    models) and 5e-2 (the bf16 LM) of the leaf's largest magnitude, plus
    1e-5 of the largest over all leaves for EfficientNet-B0; the master
    p_card - p_cpu = -lr (m_card - m_cpu) up to one f32 rounding on each
    side, 2^-21 (|p| + |p'_card| + |p'_cpu|); loss within rtol 1e-4
    (ResNet-18) and 1e-3 (LM); BN statistics within rtol 1e-4; codes
    equal."""
    from repro_torch import tree as tu
    from repro_torch.core.precision import TriAccelConfig
    from repro_torch.data.synthetic import CIFARLikeStream, LMTaskStream
    from repro_torch.models.vision import VisionConfig
    from repro_torch.train.paper_harness import _tac_for
    from repro_torch.train.task import LMTask, VisionTask
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cases = [
        ("ResNet-18", lambda dev: VisionTask(VisionConfig("resnet18"),
                                             device=dev),
         _tac_for("fp32", mem_cap_gb=1.0),
         TrainerConfig(total_steps=10, base_lr=0.05, warmup_steps=2,
                       weight_decay=5e-4, grad_clip=5.0, rungs=(2,),
                       seq_len=1),
         CIFARLikeStream(global_batch=2, seed=3).batch(0), 1e-4, 3e-2, 0.0),
        ("EfficientNet-B0", lambda dev: VisionTask(
            VisionConfig("efficientnet_b0"), device=dev),
         _tac_for("fp32", mem_cap_gb=1.0),
         TrainerConfig(total_steps=10, base_lr=0.05, warmup_steps=2,
                       weight_decay=5e-4, grad_clip=5.0, rungs=(2,),
                       seq_len=1),
         CIFARLikeStream(global_batch=2, seed=3).batch(0), 1e-4, 3e-2, 1e-5),
        ("smollm-135m x2 layers", lambda dev: LMTask(_lm_cfg(2), device=dev),
         TriAccelConfig(ladder="gpu", curvature_method="fisher",
                        enable_precision=False, enable_curvature=False,
                        enable_batch=False, dynamic_precision=False),
         TrainerConfig(total_steps=10, base_lr=0.05, warmup_steps=2,
                       grad_clip=1.0, rungs=(2,), seq_len=1024),
         LMTaskStream(49152, 1024, 2, seed=3).batch(0), 1e-3, 5e-2, 0.0),
    ]
    cpu = lambda t: t.detach().cpu().float()     # noqa: E731
    for name, make, tac, tcfg, batch, loss_rtol, mom_rel, floor in cases:
        out = {}
        for dev in ("cpu", "cuda"):
            tr = Trainer(make(dev), tac, tcfg, device=dev)
            check(not tr.fused, f"{name}: the reference step")
            b = {k: v.to(dev) for k, v in batch.items()}
            st, met = tr._step_fn(tr.state, b)
            out[dev] = (tu.leaves(tr.state.params), st, met)
        (p0, sc, mc), (_, sg, mg) = out["cpu"], out["cuda"]
        check(bool(mg["grads_finite"]) and bool(torch.isfinite(mg["loss"])),
              f"{name}: finite step on the card")
        torch.testing.assert_close(cpu(mg["loss"]), mc["loss"],
                                   rtol=loss_rtol, atol=0)
        lr = float(mc["lr"])
        check(float(mg["lr"]) == lr, f"{name}: learning rate")
        worst = 0.0
        top = max(float(m.abs().max()) for m in tu.leaves(sc.opt_state["mu"]))
        for a0, pg, pc, mg_, mc_ in zip(
                p0, tu.leaves(sg.params), tu.leaves(sc.params),
                tu.leaves(sg.opt_state["mu"]), tu.leaves(sc.opt_state["mu"])):
            pg, mg_ = cpu(pg), cpu(mg_)
            gap = float((mg_ - mc_).abs().max()) / (
                float(mc_.abs().max()) + floor / mom_rel * top)
            worst = max(worst, gap)
            dev_p = ((pg - pc) + lr * (mg_ - mc_)).abs()
            check(bool((dev_p <= 2.0 ** -21 * (a0.abs() + pc.abs()
                                               + pg.abs())).all()),
                  f"{name}: master = p - lr * m on both devices")
        check(worst <= mom_rel, f"{name}: card vs CPU momentum {worst}")
        check(torch.equal(sg.control.codes.cpu(), sc.control.codes),
              f"{name}: codes")
        for a, b in zip(tu.leaves(sg.aux_state), tu.leaves(sc.aux_state)):
            torch.testing.assert_close(cpu(a), b, rtol=1e-4, atol=1e-5)
        log(f"{name}, one reference step, card vs CPU: loss "
            f"{float(mg['loss']):.7f} vs {float(mc['loss']):.7f}; momentum "
            f"(the clipped gradient) within {worst:.3g} of each leaf's max "
            f"(limit {mom_rel})")


# ------------------------------------ phase 5b: the serving main path ---
def serve_main_path(seed: int = 0):
    """The serving main path: ServeSession over smollm-135m at full width,
    prompt 1024, cache 2048, rungs 1/2/4, tiers 1 then 0 (fp8 pinned after
    16 decode steps), eight requests of 64 tokens in two waves: four up
    front, three steps, four more. tok/s counts every generated token over
    the serving wall time from the first submit to the last token."""
    import warnings
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_task
    from repro_torch.serve import ServeConfig, ServeSession
    task = get_task("smollm-135m")
    n_layers, vocab = task.cfg.num_layers, task.cfg.vocab_size
    cfg = ServeConfig(prompt_len=1024, total_len=2048, rungs=(1, 2, 4),
                      tiers=(0, 1), ladder="tpu", max_new_tokens=64,
                      schedule="fifo", seed=seed)
    prompts = np.random.default_rng(seed).integers(0, vocab,
                                                   (8, cfg.prompt_len))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ops.WARNED_FALLBACKS.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        sess = ServeSession(task, cfg)
        t1 = time.perf_counter()
        sess.warm()
        warm_runs = dict(sess.engine.runs)
        t2 = time.perf_counter()
        for p in prompts[:4]:
            sess.submit({"tokens": p})
        for _ in range(3):
            sess.step()
        for p in prompts[4:]:
            sess.submit({"tokens": p})
        while sess.engine.runs["decode"] - warm_runs["decode"] < 16:
            sess.step()
        sess.set_tier(0)
        stats = sess.run()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t2
    launches = dict(ops.LAUNCHES)
    runs = dict(sess.engine.runs)
    fallbacks = [str(w.message) for w in caught
                 if "kernel gate failed" in str(w.message)]
    check(not fallbacks and not ops.WARNED_FALLBACKS,
          f"fallback warnings on the main path: {fallbacks}")
    reqs = sess.results()
    check(len(reqs) == 8 and all(r.status == "done" for r in reqs.values()),
          "all eight requests done")
    for r in reqs.values():
        check(len(r.tokens) == cfg.max_new_tokens and all(
            0 <= t < vocab for t in r.tokens), f"request {r.rid} tokens")
    decode_steps = sum(len(sess.lat.samples(r, t)) for r in cfg.rungs
                       for t in cfg.tiers)
    n_warm = len(cfg.rungs) * len(cfg.tiers)
    check(runs["admit"] == 8 + n_warm, f"admits {runs['admit']}")
    check(runs["decode"] == decode_steps + n_warm, f"decodes {runs}")
    check(launches["flash_attention"] == n_layers * runs["admit"],
          f"flash_attention launches {launches} vs {runs}")
    check(launches["flash_attention_tc"] == launches["flash_attention"]
          and launches["flash_attention_simt"] == 0,
          f"every prefill forward on the tensor-core route: {launches}")
    check(launches["flash_decode"] == n_layers * runs["decode"],
          f"flash_decode launches {launches} vs {runs}")
    check(launches["qdq_cast"] == launches["qdq_cast_two_pass"]
          == len(_lm_leaves()),
          f"qdq_cast launches {launches} vs the tier-0 leaves (two-pass)")
    check(any(t == 0 for _, t in stats["tier_history"]), "fp8 tier decoded")
    check(max(r for _, r in stats["rung_history"]) == 4, "rung reached 4")
    tokens = stats["decoded_tokens"]
    log(f"serving main path: smollm-135m ({n_layers} layers), 8 requests x "
        f"{cfg.max_new_tokens} tokens, prompt {cfg.prompt_len}, cache "
        f"{cfg.total_len}: init {t1 - t0:.2f} s, warm {t2 - t1:.2f} s "
        f"({sess.compile_count} paths), serving {serve_s:.3f} s")
    log(f"  {tokens / serve_s:.1f} tok/s ({tokens} tokens, {stats['steps']} "
        f"steps, {decode_steps} decode steps), TTFT p50 "
        f"{stats['ttft_s_p50'] * 1e3:.1f} ms p99 "
        f"{stats['ttft_s_p99'] * 1e3:.1f} ms, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    log(f"  rung history {stats['rung_history']}, tier history "
        f"{stats['tier_history']}, measured bytes "
        f"{ {k: int(v) for k, v in sess.mm.measured.items()} }")
    lat = {f"{r}/{t}": round(float(np.median(sess.lat.samples(r, t))) * 1e3,
                             3)
           for r in cfg.rungs for t in cfg.tiers if sess.lat.samples(r, t)}
    log(f"  median decode step ms by rung/tier {lat}")
    log(f"  path runs {runs} (warm-ups {warm_runs}), launches {launches}")
    log(f"  request 0 tokens {reqs[0].tokens[:16]} ...")
    return sess, launches


def _serve_family(n):
    if "decode_split_kernel" in n:
        return "flash_decode (this port's split-key kernel)"
    if "fwd_tc_kernel" in n:
        return "flash forward (this port's tensor-core kernel)"
    if "fwd_kernel" in n:
        return "flash forward (this port's SIMT kernel)"
    if "qdq" in n:
        return "qdq_cast (this port's kernel)"
    if any(w in n for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                            "sm90", "splitk")):
        return "matmul (projections, FFN, readout)"
    if "index" in n:
        return "cache writes, gathers (index kernels)"
    if "copy" in n or "memcpy" in n or "memset" in n:
        return "casts and copies"
    if "reduce" in n:
        return "reduction (norms, argmax)"
    return "elementwise (RoPE, norms, SiLU, residuals)"


def profile_prefill(sess) -> None:
    """Where the prefill's time goes: one serving step that admits four
    fresh prompts (4 prefills of 1024 tokens through 30 layers, the
    scatter into the cache, one decode step at rung 4)."""
    rng = np.random.default_rng(12)
    for _ in range(4):
        sess.submit({"tokens": rng.integers(0, sess.task.cfg.vocab_size,
                                            (sess.cfg.prompt_len,))},
                    max_new_tokens=2)
    _profile(sess.step, 1, _serve_family,
             "1 serving step admitting 4 prompts of "
             f"{sess.cfg.prompt_len} tokens")
    sess.run()


def profile_decode(sess, steps: int = 5) -> None:
    """Where a decode step's time goes: ``steps`` decode steps at rung 4
    (four fresh requests admitted first)."""
    rng = np.random.default_rng(11)
    for _ in range(4):
        sess.submit({"tokens": rng.integers(0, sess.task.cfg.vocab_size,
                                            (sess.cfg.prompt_len,))},
                    max_new_tokens=steps + 4)
    sess.step()              # admits all four, one decode step
    sess.step()

    def run():
        for _ in range(steps):
            sess.step()

    _profile(run, steps, _serve_family,
             f"{steps} decode steps at rung {sess.rung} tier {sess.tier}")
    sess.run()


# --------------------------- phase 8: checkpoint, resume and preemption ---
#: ResNet-18's checkpointed run: its steps, checkpoint cadence and
#: generations kept, and the steps both trainers take after the restore
CKPT_STEPS, CKPT_EVERY, CKPT_KEEP, CKPT_MORE = 20, 10, 2, 5
#: the LM launcher's first call takes SIGTERM in the step before this one
LM_CKPT_CUT = 10


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _generations(directory) -> list:
    """Committed steps of a checkpoint directory; fails on a leftover
    temporary file or directory."""
    names = sorted(p.name for p in Path(directory).iterdir())
    check(not any(".tmp" in n for n in names),
          f"no temporary remnants in {names}")
    return sorted(int(n[len("step_"):-len(".COMMITTED")]) for n in names
                  if n.endswith(".COMMITTED"))


def _bits(t: torch.Tensor) -> torch.Tensor:
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.detach().cpu().contiguous().view(ints[t.element_size()])


def _differing(a, b) -> list:
    """Key paths where two trees of tensors differ in any bit (slabs
    compared whole, padding rows included)."""
    from repro_torch import tree as tu
    return [k for k, x, y in zip(tu.keystrs(a), tu.leaves(a), tu.leaves(b))
            if x.shape != y.shape or x.dtype != y.dtype
            or not torch.equal(_bits(x), _bits(y))]


def _save_timings(tr, directory: str, reps: int) -> dict:
    """``reps`` saves of the trainer's state through an
    ``AsyncCheckpointer``: the host stall of ``save()`` (unpack and the
    device-to-host copy), then the background write (``wait()``), medians
    in ms; the bytes of one generation, held to the master, momentum and
    compute copy of every parameter plus 1 % (headers, control, BatchNorm
    state)."""
    from repro_torch import tree as tu
    from repro_torch.checkpoint import AsyncCheckpointer
    ckpt = AsyncCheckpointer(directory, keep=1)
    step = int(tr.state.control.step)
    stall, write = [], []
    for _ in range(reps):
        _sync(tr.device)
        t0 = time.perf_counter()
        ckpt.save(step, tr._save_state())
        t1 = time.perf_counter()
        ckpt.wait()
        stall.append((t1 - t0) * 1e3)
        write.append((time.perf_counter() - t1) * 1e3)
    nbytes = sum(f.stat().st_size
                 for f in (Path(directory) / f"step_{step:012d}").iterdir())
    n = sum(p.numel() for p in tu.leaves(tr._params_like))
    cp = torch.empty((), dtype=tr.task.compute_dtype).element_size()
    want = n * (4 + 4 + cp)
    check(want <= nbytes <= 1.01 * want,
          f"{nbytes} bytes a generation, {want} in its three copies")
    return {"bytes": nbytes, "stall_ms": statistics.median(stall),
            "write_ms": statistics.median(write)}


def checkpoint_resnet(batch0: int = 32, dev="cuda") -> dict:
    """The paper's Tri-Accel ResNet-18 trainer (``make_trainer``, resident
    fused step) with a checkpoint directory: ``CKPT_STEPS`` steps with a
    generation every ``CKPT_EVERY`` and ``CKPT_KEEP`` kept; a fresh trainer
    restores the last bitwise (every slab, padding included, ``p_amax``,
    control, BatchNorm state, the serving absmax table), and so does one
    on the CPU; both card trainers then take ``CKPT_MORE`` steps (the
    restored one launching ``fused_stats`` and ``fused_apply`` once a step)
    and their losses agree, bitwise where the card's step is deterministic,
    else within rtol 1e-3; the live trainer's generations after them show
    the keep-N collection; a generation the CPU trainer writes restores on
    the card bitwise. -> the save, write and restore times and the bytes
    of one generation."""
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.kernels import ops
    from repro_torch.train.paper_harness import make_trainer
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    run, on_cpu = str(tmp / "run"), str(tmp / "cpu")
    try:
        def trainer(directory, device=dev):
            tr = make_trainer("triaccel", "resnet18", steps=CKPT_STEPS,
                              batch0=batch0, ckpt_dir=directory,
                              device=device)[0]
            tr.tcfg.ckpt_keep = tr.ckpt.keep = CKPT_KEEP
            return tr
        live = trainer(run)
        check(live.tcfg.ckpt_every == CKPT_EVERY, "the harness's cadence")
        live.run(CKPT_STEPS)
        _sync(dev)
        check(_generations(run) == [CKPT_EVERY, CKPT_STEPS],
              f"generations {_generations(run)}")
        out = _save_timings(live, str(tmp / "timing"), reps=3)
        fresh = trainer(run)
        _sync(dev)
        t0 = time.perf_counter()
        step = fresh.maybe_restore()
        _sync(dev)
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        check(step == int(live.state.control.step) == CKPT_STEPS,
              f"restored step {step}")
        bad = _differing(fresh.state, live.state)
        check(not bad, f"restored on the card, bitwise: {bad}")
        check(not _differing(fresh.serving_amax_tree(),
                             live.serving_amax_tree()), "serving table")
        cpu = trainer(run, "cpu")
        check(cpu.maybe_restore() == CKPT_STEPS
              and not _differing(cpu.state, live.state),
              "the card's generation restored on the CPU, bitwise")
        # the rung controller's host state is in no checkpoint (nor in the
        # reference's): the restored trainer takes the live one's, and
        # writes nothing (the live trainer owns the directory)
        fresh.scaler = copy.deepcopy(live.scaler)
        fresh.measured_bytes = dict(live.measured_bytes)
        fresh.ckpt = None
        ops.reset_launches()
        fresh.run(CKPT_MORE)
        _sync(dev)
        launches = dict(ops.LAUNCHES)
        check(launches["fused_stats"] == launches["fused_apply"] == CKPT_MORE,
              f"launches in {CKPT_MORE} steps after the restore: {launches}")
        live.run(CKPT_MORE)
        la = [m["loss"] for m in live.metrics_log[-CKPT_MORE:]]
        lb = [m["loss"] for m in fresh.metrics_log[-CKPT_MORE:]]
        check(all(math.isfinite(x) for x in la + lb), f"losses {la} {lb}")
        gap = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
        bitwise = la == lb and not _differing(fresh.state, live.state)
        check(bitwise or gap <= 1e-3, f"losses after the restore {lb} vs "
              f"the live run's {la}")
        check(_generations(run) == [CKPT_STEPS, CKPT_STEPS + CKPT_MORE],
              f"keep {CKPT_KEEP}: {_generations(run)}")
        cpu.ckpt = AsyncCheckpointer(on_cpu, CKPT_KEEP)
        cpu.run(1)
        fresh.tcfg.ckpt_dir = on_cpu
        check(fresh.maybe_restore() == CKPT_STEPS + 1
              and not _differing(fresh.state, cpu.state),
              "a CPU-written generation restored on the card, bitwise")
        log(f"checkpoint, ResNet-18 Tri-Accel from rung {batch0}: "
            f"generations {CKPT_EVERY}, {CKPT_STEPS} of {CKPT_STEPS} steps, "
            f"restored on the card and on the CPU bitwise; {CKPT_MORE} more "
            f"steps on the restored and the live trainer: losses "
            f"{'bitwise equal' if bitwise else f'within {gap:.3g}'} "
            f"({lb}), launches after the restore "
            f"{ {k: v for k, v in launches.items() if v} }; keep "
            f"{CKPT_KEEP} left {_generations(run)}; a CPU-written "
            f"generation restored on the card bitwise")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def checkpoint_lm() -> dict:
    """smollm-135m through ``launch.train.main(LM_TRAIN_ARGS + ["--ckpt",
    dir])``: the first call takes SIGTERM in step ``LM_CKPT_CUT - 1``
    (as a cluster reclaiming the card would send it), checkpoints at the
    top of the next step and exits with 143; the same call again prints
    ``resumed at step LM_CKPT_CUT`` and takes the remaining steps, its
    launch counts read around it (the flash forward, its three backward
    kernels and the fused update, as in phase 5c). Then the times of a
    save and of ``maybe_restore`` into the same trainer, which must give
    back its state bitwise."""
    import io
    from repro_torch import tree as tu
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.train.trainer import Trainer
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_ckpt_"))
    run = str(tmp / "run")
    argv = LM_TRAIN_ARGS + ["--ckpt", run]
    kw = dict(t_ctrl=LM_T_CTRL, t_curv=LM_T_CURV)
    steps = int(LM_TRAIN_ARGS[LM_TRAIN_ARGS.index("--steps") + 1])
    dispatch = Trainer._dispatch

    def sigterm_before_the_cut(self, step):
        if step == LM_CKPT_CUT - 1:
            signal.raise_signal(signal.SIGTERM)
        return dispatch(self, step)
    try:
        code = None
        with signals_kept(), contextlib.redirect_stdout(io.StringIO()):
            Trainer._dispatch = sigterm_before_the_cut
            try:
                launch_train.main(argv, **kw)
            except SystemExit as e:
                code = e.code
            finally:
                Trainer._dispatch = dispatch
        check(code == 143 and _generations(run) == [LM_CKPT_CUT],
              f"preempted: exit {code}, generations {_generations(run)}")
        torch.cuda.synchronize()
        ops.reset_launches()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with signals_kept(), contextlib.redirect_stdout(printed):
            tr = launch_train.main(argv, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        lines = printed.getvalue().splitlines()
        check(lines[0] == f"resumed at step {LM_CKPT_CUT}", f"{lines[:1]}")
        check(int(tr.state.control.step) == steps, "all steps taken")
        losses = [json.loads(x)["loss"] for x in lines[1:]]
        check(losses and all(math.isfinite(x) for x in losses),
              f"losses {losses}")
        rest, L = steps - LM_CKPT_CUT, tr.task.cfg.num_layers
        want = {"flash_attention": 2 * L * rest,
                "flash_attention_tc": 2 * L * rest,
                "flash_attention_bwd_delta": L * rest,
                "flash_attention_bwd_dq_tc": L * rest,
                "flash_attention_bwd_dkv_tc": L * rest,
                "fused_stats": rest, "fused_apply": rest}
        for k, n in want.items():
            check(launches[k] == n, f"{k}: {launches[k]} launches after the "
                  f"resume, expected {n}")
        check(_generations(run) == [LM_CKPT_CUT, steps],
              f"generations {_generations(run)}")
        out = _save_timings(tr, str(tmp / "timing"), reps=2)
        before = tu.tree_map(lambda x: x.clone(), tr.state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(tr.maybe_restore() == steps, "restored step")
        torch.cuda.synchronize()
        out["restore_ms"] = (time.perf_counter() - t0) * 1e3
        bad = _differing(tr.state, before)
        check(not bad, f"restored on the card, bitwise: {bad}")
        log(f"checkpoint, smollm-135m through launch.train.main("
            f"{' '.join(argv)}): SIGTERM in step {LM_CKPT_CUT - 1}, exit "
            f"143 with generation {LM_CKPT_CUT}; the same call again resumed "
            f"and took {rest} steps in {wall:.2f} s (init included), losses "
            f"{[round(x, 4) for x in losses]}, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="ResNet-18 main-path steps")
    ap.add_argument("--batch0", type=int, default=32)
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and hold the kernels against their plain "
                         "versions (phases 1-3), then stop; prints no "
                         "result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    card = card_line()
    name = torch.cuda.get_device_name(0)
    bw, f32_ops, tc_ops, tf32_ops = peaks(name)
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    srcs = sorted(p.stem for p in (ROOT / CSRC).glob("*.cu"))
    procs = {s: _build.start_build(s) for s in srcs}     # all at once
    for s, proc in procs.items():
        _build.finish_build(s, proc)
        _build.load(s)
    log(f"built {srcs} in {time.perf_counter() - t0:.1f} s")
    for s, text in _build.BUILD_LOG.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", text))
        smem = [int(w) for w in re.findall(r"(\d+) bytes smem", text)]
        log(f"  ptxas {s}: {len(regs)} kernels, at most {max(regs)} "
            f"registers a thread, {spills} bytes of spills, static smem "
            f"at most {max(smem, default=0)} bytes")
        if s in ("flash_fwd_sm90", "flash_bwd_sm90", "flash_attention_bwd",
                 "flash_bwd_tf32", "flash_decode_sm90"):
            for kern, nreg, spill in ptxas_kernels(text):
                log(f"    {s}: {kern}: {nreg} registers, {spill} bytes of "
                    "spill stores")
                check(not spill or not s.endswith("sm90"),
                      f"no spills in the Hopper (sm90) sources: {kern}")

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    view = vision_view()
    res = {"fused_stats": check_stats(view, dev, bw, f32_ops),
           "fused_apply": check_apply_main(view, dev, bw, f32_ops)}
    res["fused_apply"]["max_abs_err"] = max(res["fused_apply"]["max_abs_err"],
                                            check_apply_variants(dev))
    eff_view = vision_view("efficientnet_b0")
    res["fused_stats@efficientnet_b0"] = check_stats(
        eff_view, dev, bw, f32_ops, what="EfficientNet-B0")
    res["fused_apply@efficientnet_b0"] = check_apply_main(
        eff_view, dev, bw, f32_ops, what="EfficientNet-B0")
    lm_view, lm_var = lm_train_view(), lm_train_variant()
    res["fused_stats@lm_train"] = check_stats(
        lm_view, dev, bw, f32_ops, g_dtype=lm_var["g_dtype"],
        what="smollm-135m")
    res["fused_apply@lm_train"] = check_apply_main(
        lm_view, dev, bw, f32_ops, what="smollm-135m", **lm_var)
    del lm_view
    res.update(check_qdq(dev, bw, f32_ops))
    res.update(check_flash(dev, bw, f32_ops, tc_ops))
    res["flash_decode"] = check_decode(dev, bw, tc_ops)
    delta_err = check_delta(dev)
    res.update(check_flash_bwd(dev, bw, f32_ops, tc_ops, tf32_ops))
    res["flash_attention_bwd_delta"]["max_abs_err"] = max(
        res["flash_attention_bwd_delta"]["max_abs_err"], delta_err)
    for k, n in check_flash_function(dev).items():
        res[k]["f32_function_launches"] = n
    res["grad_stats"] = check_grad_stats(dev, bw, f32_ops)
    log(f"kernel checks in {time.perf_counter() - t_phase:.1f} s")
    if args.kernels_only:
        return 0

    t_phase = time.perf_counter()
    check_step_against_cpu()
    check_step_against_cpu("efficientnet_b0", floor=1e-5)
    check_curvature_against_cpu()
    check_lm_against_cpu()
    check_lm_step_against_cpu()
    check_reference_steps_against_cpu()
    log(f"card-vs-CPU checks in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    launches = main_path(args.steps, args.batch0)[0]
    eff_launches, eff_ms, eff_peak, eff_rungs = main_path(
        EFF_STEPS, args.batch0, "efficientnet_b0")
    for k in ("fused_stats", "fused_apply"):
        launches[f"{k}@efficientnet_b0"] = eff_launches[k]
    hutchinson_main_path()
    sess, serve_launches = serve_main_path()
    for k in ("qdq_cast", "flash_decode"):
        launches[k] = serve_launches[k]
    log(f"main paths in {time.perf_counter() - t_phase:.1f} s")
    profile_steps(args.batch0)
    profile_steps(args.batch0, arch="efficientnet_b0")
    profile_prefill(sess)
    profile_decode(sess)
    del sess                  # the LM trainer's measured bytes are its own
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    lm_tr, lm_launches, one_pass = lm_train_main_path()
    launches["qdq_cast_one_pass"] = one_pass
    # a kernel that runs on two paths at different shapes has a row for
    # each: its launches on that path beside its time at that path's shape
    launches["flash_attention"] = serve_launches["flash_attention"]
    for k in ("fused_stats", "fused_apply", "flash_attention"):
        launches[f"{k}@lm_train"] = lm_launches[k]
    for k in ("flash_attention_bwd_delta", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        launches[k] = lm_launches[k]
    check(all(lm_launches[f"{k}_tc"] == lm_launches[k]
              for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")),
          "every LM dQ and dK/dV launch on the tensor-core route")
    log(f"LM training main path in {time.perf_counter() - t_phase:.1f} s")
    time_lm_rungs(lm_tr)
    profile_lm_step(lm_tr)
    del lm_tr                 # the reference paths' peaks are their own
    gc.collect()
    torch.cuda.empty_cache()

    # the reference step's main paths, each with its counts read around it;
    # grad_stats' path is its op over each path's gradient tree
    t_phase = time.perf_counter()
    gs_resnet = fp32_main_path()[0]
    profile_steps(FP32_ARGS["batch0"], method="fp32")
    gs_eff, eff_fp32_ms, eff_fp32_peak = fp32_main_path(
        "efficientnet_b0", "EfficientNet-B0", bw, f32_ops)
    profile_steps(FP32_ARGS["batch0"], method="fp32", arch="efficientnet_b0")
    # the paper's comparison (Table 1's EfficientNet-B0 rows): measured here,
    # asserted nothing about
    from repro_torch.train.paper_harness import PAPER_FP32_GB
    log(f"EfficientNet-B0 from rung {args.batch0}: Tri-Accel median step "
        f"{eff_ms:.3f} ms (the controller's rungs {eff_rungs} at steps 10, "
        f"20, ...), peak allocated {eff_peak / 1e9:.3f} GB; "
        f"FP32 (rung fixed) median step {eff_fp32_ms:.3f} ms, peak "
        f"allocated {eff_fp32_peak / 1e9:.3f} GB; the paper's FP32 point "
        f"{PAPER_FP32_GB['efficientnet_b0']} GB (its memory model's "
        "calibration, batch 96)")
    gc.collect()
    torch.cuda.empty_cache()
    nt_launches, gs_lm = no_triaccel_main_path(bw, f32_ops)
    # the SIMT forward's launches on the three LM paths (each checked 0)
    launches["flash_attention_simt"] = sum(
        d["flash_attention_simt"]
        for d in (serve_launches, lm_launches, nt_launches))
    # likewise the split-TF32 and SIMT dQ and dK/dV on the two LM training
    # paths (f32 callers' routes; the f32 autograd check counts them)
    for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        for route in ("tf32", "simt"):
            launches[f"{k}_{route}"] = sum(
                d[f"{k}_{route}"] for d in (lm_launches, nt_launches))
    launches["grad_stats"] = gs_resnet["launches"]
    res["grad_stats"]["max_abs_err"] = max(res["grad_stats"]["max_abs_err"],
                                           gs_resnet["max_abs_err"])
    launches["grad_stats@lm_reference"] = gs_lm.pop("launches")
    res["grad_stats@lm_reference"] = gs_lm
    launches["grad_stats@efficientnet_b0_reference"] = gs_eff.pop("launches")
    res["grad_stats@efficientnet_b0_reference"] = gs_eff
    log(f"reference main paths in {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # checkpoint, resume and preemption: each resumed path with its counts
    # read around it; the card's numbers printed beside its name and limit
    t_phase = time.perf_counter()
    saved = {"ResNet-18": checkpoint_resnet(args.batch0),
             "smollm-135m": checkpoint_lm()}
    for what, r in saved.items():
        log(f"checkpoint, {what} ({card}): one generation {r['bytes']} "
            f"bytes; save() host stall {r['stall_ms']:.3f} ms (unpack and "
            f"device-to-host copy), background write {r['write_ms']:.3f} "
            f"ms, maybe_restore on the card {r['restore_ms']:.3f} ms")
    log(f"checkpoint phase in {time.perf_counter() - t_phase:.1f} s")

    rows = [{"name": rname, "route": "cuda", "source": src,
             "replaces": replaces, "launches": launches[rname],
             **res[rname]}
            for kname, (src, replaces) in KERNELS.items()
            for rname in res if rname.split("@")[0] == kname]
    check(len(rows) == len(res) and {r["name"].split("@")[0] for r in rows}
          == set(KERNELS), "a row for every kernel and every result")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
