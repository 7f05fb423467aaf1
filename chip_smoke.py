#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # from the repository root

Phases (any failure raises and the script exits non-zero):

  1. the card (``nvidia-smi``), torch and CUDA versions;
  2. build every CUDA source under ``src/repro_torch/kernels/csrc`` with
     ``nvcc`` (all sources at once), print the seconds and the ptxas report;
  3. hold each kernel against its plain PyTorch version on the card, time
     both with CUDA events, compute the least time the card could take
     (``bound_ms``) and time one PyTorch call computing the same function
     where there is one (``library_ms``):
       - fused_stats / fused_apply at the ResNet-18 slab shape (22,016 x
         512, 11 layers) and over every fused_apply variant, bitwise;
       - qdq_cast over every variant and over all of smollm-135m's leaves
         (the main path's tier-0 cast), bitwise;
       - flash_attention over every variant at the test shapes and at the
         main path's prefill (S 1024, 9/3 heads, head_dim 64, bf16);
       - flash_decode over ragged lengths (0, 1, L, between) and at the
         main path's decode (4 rows against a 2048-slot cache);
  4. correctness of whole steps: one slab-resident train step of ResNet-18
     at batch 4, and one prefill plus 4 teacher-forced decode steps of
     smollm-135m at full width and 2 layers, each on the card against the
     same on the CPU (plain versions), from the same weights;
  5. the main paths, with the kernels' launch counts read around each:
       - ``run_method("triaccel", "resnet18", steps=50, batch0=32)``;
       - serving: ``ServeSession`` over smollm-135m at full width (30
         layers), prompt 1024, cache 2048, rungs 1/2/4, tiers 1 then 0,
         eight requests of 64 tokens in two waves; the launch counts must
         equal 30 x prefills (flash_attention), 30 x decode steps
         (flash_decode) and the tier-0 leaves (qdq_cast), and no attention
         gate may fall back;
  6. where the time goes: ``torch.profiler`` over a few ResNet-18 train
     steps and over a few decode steps at rung 4.

The last three lines are the ``kernels`` JSON line, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a card (or
outside a checkout of the repository) it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
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
    "flash_attention": (f"{CSRC}/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:222"),
    "flash_decode": (f"{CSRC}/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:546"),
}
# published peaks of the H100 SXM (NVIDIA's data sheet): device memory
# bytes/s, f32 operations/s outside the tensor cores, and bf16 tensor-core
# operations/s (dense)
PEAKS = {"H100": (3.35e12, 67e12, 989e12)}


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
def resnet18_view():
    from repro_torch.core.grouping import flat_grouping
    from repro_torch.kernels.layout import slab_view
    from repro_torch.models.vision import VisionConfig, vision_init
    params, _ = vision_init(torch.Generator(), VisionConfig("resnet18"),
                            device="meta")
    return slab_view(params, flat_grouping(params))


def check_stats(view, dev, bw, f32_ops):
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ops
    rows, L = view.rows, view.num_layers
    gen = torch.Generator(device=dev).manual_seed(1)
    # three gradient slabs, 135 MB in all, so each timed launch finds its
    # input out of the 50 MB L2 cache, as after a real backward
    gs = [torch.randn((rows, 512), generator=gen, device=dev) * 1e-3
          for _ in range(3)]
    g = gs[0]
    g[5, 7], g[300, 0], g[301, 511] = float("inf"), -float("inf"), float("nan")
    g[9000, 100:110] = float("nan")
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
    log(f"fused_stats sum: kernel and plain off the f64 sum by at most "
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
        k[0] = (k[0] + 1) % 3
        lib.tri_fused_stats(gs[k[0]].data_ptr(), 0, rl.data_ptr(), rows, L,
                            part.data_ptr(), out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)

    ms = time_ms(raw, iters=30)
    plain_ms = time_ms(lambda: fu.fused_stats_ref(g, rl, L), iters=5)
    nbytes = rows * 512 * 4 + rows * 4 + 4 * L * 4
    nops = rows * 512 * 8      # isfinite, select, add, mul+add, add, abs+max
    b_ms, by = bound(nbytes, nops, bw, f32_ops)
    log(f"fused_stats {rows}x512 f32 L={L}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), max|err| {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


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


def check_apply_main(view, dev, bw, f32_ops):
    """fused_apply at the main path's shape and variant (sgdm, gpu ladder,
    f32 copy) — bitwise against the plain version, then timed."""
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ops
    rows, L = view.rows, view.num_layers
    g, p, m, _, _, lr, _, qs = _apply_inputs(rows, L, dev, False, 3)
    rl = view.row_blocks(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    code = torch.randint(0, 3, rl.shape, generator=gen, device=dev,
                         dtype=torch.int32)
    spec = fu.OptSpec("sgdm", momentum=0.9, weight_decay=5e-4)
    kw = dict(spec=spec, ladder="gpu", cp_dtype=torch.float32, num_layers=L)
    scal = torch.tensor([0.5, 1.0, 1.0, 1.0, 7.0], device=dev)
    err = _apply_pair(ops, fu, (g, p, m, None, scal, rl, lr, code, qs), kw)
    lib = fu._lib()
    outs = [torch.empty_like(p) for _ in range(3)]
    part = torch.empty((rows // lib.tri_rows_per_block()) * L, device=dev)
    pmax = torch.empty((L,), device=dev)
    ptrs = [t.data_ptr() for t in (g, p, m)] + [None] + \
        [t.data_ptr() for t in (scal, rl, lr, code, qs)] + \
        [t.data_ptr() for t in outs[:2]] + [None, outs[2].data_ptr(),
                                            part.data_ptr(), pmax.data_ptr()]

    def raw():          # the kernel alone: no checks, no allocation
        lib.tri_fused_apply(0, 0, 0, 0, 0, 0, spec.momentum, spec.b1,
                            1.0 - spec.b1, spec.b2, 1.0 - spec.b2, spec.eps,
                            spec.weight_decay, *ptrs, rows, L,
                            torch.cuda.current_stream().cuda_stream)

    ms = time_ms(raw, iters=20)
    plain_ms = time_ms(lambda: fu.fused_apply_ref(
        g, p, m, None, scal, rl, lr, code, qs, **kw), iters=3)
    slab = rows * 512 * 4
    nbytes = 6 * slab + 4 * rows * 4 + 5 * 4 + L * 4   # g,p,m in; p,m,cp out
    nops = rows * 512 * 16      # scale, wd, momentum, lr step, casts, absmax
    b_ms, by = bound(nbytes, nops, bw, f32_ops)
    log(f"fused_apply {rows}x512 sgdm/gpu/f32: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), max|err| {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


# ------------------------------------------ phase 4: one step, two devices ---
def check_step_against_cpu():
    """One resident step of ResNet-18 at batch 4 on the card (kernels) and
    on the CPU (plain versions), from the same weights, state and batch.
    cuDNN and the CPU convolve in other summation orders (both full f32,
    TF32 off), so the gradient is held leaf by leaf within 3e-2 of the
    leaf's largest magnitude (the spread the reference's own CPU gradient
    shows against f64 in the first block; see tests/test_torch_vision.py),
    and everything downstream of it follows from the gradient by the
    update's arithmetic:
      master   p_card - p_cpu = -lr * (m_card - m_cpu), up to 2^-21 (|p|+|p'|)
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
        tr = Trainer(VisionTask(VisionConfig("resnet18"), device=dev), tac,
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
    worst = 0.0
    for slot in view.slots:
        rows = slice(slot.row_off, slot.row_off + slot.stack * slot.rows_per)
        gap = float((mo_g[rows] - mo_c[rows]).abs().max())
        worst = max(worst, gap / float(mo_c[rows].abs().max()))
    check(worst <= 3e-2, f"card vs CPU clipped gradient: {worst}")
    lr = float(mc["lr"])
    check(float(mg["lr"]) == lr, "learning rate")
    p_g, p_c = cpu(sg.params), sc.params
    dev_p = ((p_g - p_c) + lr * (mo_g - mo_c)).abs()
    check(bool((dev_p <= 2.0 ** -21 * (p0.abs() + p_c.abs())).all()),
          "master = p - lr * m on both devices")
    gap_p = float((p_g - p_c).abs().max())
    cp_g, cp_c = cpu(sg.compute["slab"]), sc.compute["slab"].float()
    check(bool(((cp_g - cp_c).abs() <= 2.0 ** -7 * cp_c.abs() + 2 * gap_p
                + 2.0 ** -24).all()), "compute copy")
    check(torch.equal(sg.control.codes.cpu(), sc.control.codes), "codes")
    for a, b in zip(tu.leaves(sg.aux_state), tu.leaves(sc.aux_state)):
        torch.testing.assert_close(cpu(a), b, rtol=1e-4, atol=1e-5)
    log(f"one step, card vs CPU: loss {float(mg['loss']):.7f} vs "
        f"{float(mc['loss']):.7f}; momentum (the clipped gradient) within "
        f"{worst:.3g} of each leaf's max; max|dmaster| {gap_p:.3g}; codes "
        f"{sg.control.codes.tolist()}")


# ------------------------------------------------- phase 5: main path ---
def main_path(steps: int, batch0: int):
    from repro_torch.kernels import ops
    from repro_torch.train.paper_harness import run_method
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = run_method("triaccel", "resnet18", steps=steps, batch0=batch0,
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
    log(f"main path: run_method('triaccel', 'resnet18', steps={steps}, "
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
    return launches


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


def profile_steps(batch0: int, warm: int = 6, steps: int = 5) -> None:
    """Where a train step's time goes: ``steps`` steps of the main path's
    trainer after ``warm`` steps."""
    from repro_torch.train.paper_harness import make_trainer
    trainer = make_trainer("triaccel", "resnet18", steps=50, batch0=batch0,
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
             f"{steps} train steps at rung {trainer.scaler.microbatch}")


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


def _lm_leaves():
    """The floating leaves of smollm-135m's parameters, as shapes."""
    from repro_torch import tree as tu
    from repro_torch.configs import smollm_135m
    from repro_torch.models.lm import lm_init
    params = lm_init(torch.Generator(), smollm_135m.config(), device="meta")
    return [tuple(x.shape) for x in tu.leaves(params)]


def check_qdq(dev, bw, ops_rate):
    """qdq_cast bitwise against its plain version over every variant
    (ladders, codes, f32/bf16, tile-filling and ragged sizes, no / given /
    too-small amax with the NaN rule), then at the main path's shapes:
    the tier-0 cast of all of smollm-135m's leaves, timed whole."""
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
    log(f"qdq_cast: {n} variants bitwise equal to the plain version")

    # main path: every leaf of the full-width model, f32 in and out
    xs = [torch.randn(s, generator=gen, device=dev) * 0.05
          for s in _lm_leaves()]
    err = 0.0
    for x in xs:
        got = ops.qdq_cast(x, 0, "tpu")
        want = qc.qdq_cast_ref(x, 0, "tpu")
        check(same(got, want), f"qdq_cast leaf {tuple(x.shape)}")
        err = max(err, abs_err(got, want))
    lib = qc._lib()
    outs = [torch.empty_like(x) for x in xs]
    scratch = torch.empty((1,), device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def raw():          # the kernel alone: no checks, no allocation
        for x, o in zip(xs, outs):
            lib.tri_qdq_cast(x.data_ptr(), 0, x.numel(), 0, 1, None,
                             scratch.data_ptr(), o.data_ptr(), stream)

    amaxes = [x.abs().amax().reshape(1) for x in xs]

    def raw_given():    # the single-phase form: each leaf's absmax given
        for x, o, a in zip(xs, outs, amaxes):
            lib.tri_qdq_cast(x.data_ptr(), 0, x.numel(), 0, 1, a.data_ptr(),
                             scratch.data_ptr(), o.data_ptr(), stream)

    ms = time_ms(raw, iters=10)
    plain_ms = time_ms(lambda: [qc.qdq_cast_ref(x, 0, "tpu") for x in xs],
                       iters=2, reps=3)
    ms1 = time_ms(raw_given, iters=10)
    plain1 = time_ms(lambda: [qc.qdq_cast_ref(x, 0, "tpu", a)
                              for x, a in zip(xs, amaxes)], iters=2, reps=3)
    elems = sum(x.numel() for x in xs)
    b_ms, by = bound(8.0 * elems, 6.0 * elems, bw, ops_rate)
    log(f"qdq_cast, tier-0 cast of {len(xs)} leaves ({elems} f32): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}); "
        f"with each leaf's amax given (single phase): kernel {ms1:.4f} ms, "
        f"plain {plain1:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


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


def check_flash(dev, bw, tc_rate):
    """The forward kernel against its plain version over every variant
    (causal, not causal, window, segments, LSE; f32 and bf16) at the test
    shapes, then at the main path's prefill: B 1, S 1024, 9 heads, kv 3,
    head_dim 64, bf16, causal."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(6)
    err, n = 0.0, 0
    cases = [(S, hk, D) for S in (256, 512) for hk in ((4, 2), (9, 3))
             for D in (16, 64)]
    for S, (H, K), D in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((2, S, h, D), generator=gen, device=dev
                                   ).to(dtype) for h in (H, K, K))
            for variant in ("causal", "noncausal", "window", "segments"):
                seg = _segments(2, S, dev, S) if variant == "segments" \
                    else None
                kw = dict(causal=variant != "noncausal",
                          window=100 if variant == "window" else 0)
                o, lse = fa.flash_attention_cuda(q, k, v, seg, with_lse=True,
                                                 **kw)
                o_r, lse_r = fa.flash_attention_ref(q, k, v, seg,
                                                    with_lse=True, **kw)
                what = f"flash {S} {H}/{K} {D} {dtype} {variant}"
                err = max(err, close(o, o_r, what))
                check(bool((lse - lse_r).abs().max()
                           <= 1e-5 * (1 + lse_r.abs().max())), what + " lse")
                n += 1
    torch.cuda.synchronize()
    log(f"flash_attention: {n} variants within tolerance "
        f"(max|err| {err:.3g})")

    B, S, H, K, D = 1, 1024, 9, 3, 64
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev
                           ).to(torch.bfloat16) for h in (H, K, K))
    got = ops.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_ref(q, k, v, causal=True)
    err = max(err, close(got, want, "flash main shape"))
    lib = fa._lib()
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        lib.tri_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                          o.data_ptr(), None, 1, B, S, H, K, D, D, 1, 0,
                          D ** -0.5, stream)

    ms = time_ms(raw, iters=20)
    plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v), iters=3)
    lib_ms = time_ms(lambda: _sdpa(q, k, v, is_causal=True), iters=20)
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * K * D)
    pairs = B * H * S * (S + 1) / 2            # causal pairs this run needs
    b_ms, by = bound(nbytes, pairs * 4 * D, bw, tc_rate)
    log(f"flash_attention B{B} S{S} H{H}/K{K} D{D} bf16 causal: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}


def check_decode(dev, bw, tc_rate):
    """The ragged decode kernel against its plain version at the test
    shapes (lengths 0, 1, L and between; f32 and bf16) and at the main
    path's: B 4 against a 2048-slot bf16 cache, live lengths 1024-1088."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(7)
    err, n = 0.0, 0
    for (H, K), D, L in (((4, 2), 16, 256), ((9, 3), 64, 256),
                         ((9, 3), 64, 2048)):
        for dtype in (torch.float32, torch.bfloat16):
            B = 6
            q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(dtype)
            k, v = (torch.randn((B, L, K, D), generator=gen, device=dev
                                ).to(dtype) for _ in range(2))
            lens = torch.tensor([0, 1, L, 77, L // 2, L - 1],
                                dtype=torch.int32, device=dev)
            got = fa.flash_decode_cuda(q, k, v, lens)
            want = fa.flash_decode_ref(q, k, v, lens)
            err = max(err, close(got, want,
                                 f"decode {H}/{K} {D} L{L} {dtype}"))
            check(bool((got[0] == 0).all()), "decode: length 0 gives 0")
            n += 1
    log(f"flash_decode: {n} variants within tolerance (max|err| {err:.3g})")

    B, L, H, K, D = 4, 2048, 9, 3, 64
    q = torch.randn((B, 1, H, D), generator=gen, device=dev
                    ).to(torch.bfloat16)
    k, v = (torch.randn((B, L, K, D), generator=gen, device=dev
                        ).to(torch.bfloat16) for _ in range(2))
    lens = torch.tensor([1088, 1071, 1040, 1024], dtype=torch.int32,
                        device=dev)
    got = ops.flash_decode(q, k, v, lens)
    want = fa.flash_decode_ref(q, k, v, lens)
    err = max(err, close(got, want, "decode main shape"))
    lib = fa._lib()
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        lib.tri_flash_decode(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             lens.data_ptr(), o.data_ptr(), 1, B, L, H, K, D,
                             D, D ** -0.5, stream)

    ms = time_ms(raw, iters=50)
    plain_ms = time_ms(lambda: fa.flash_decode_ref(q, k, v, lens), iters=5)
    mask = (torch.arange(L, device=dev)[None, :] < lens[:, None]
            ).reshape(B, 1, 1, L)
    lib_ms = time_ms(lambda: _sdpa(q, k, v, attn_mask=mask), iters=50)
    live = int(lens.sum())
    nbytes = 2 * (2 * B * H * D + 2 * live * K * D) + 4 * B
    b_ms, by = bound(nbytes, live * H * 4 * D, bw, tc_rate)
    log(f"flash_decode B{B} L{L} H{H}/K{K} D{D} bf16, live {lens.tolist()}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
        f"bound {b_ms:.5f} ms ({by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}


# ------------------------------- phase 4b: LM serving, card vs CPU ---
def check_lm_against_cpu(layers: int = 2, prompt: int = 1024,
                         total: int = 2048, steps: int = 4):
    """One prefill plus ``steps`` teacher-forced decode steps of
    smollm-135m at full width and ``layers`` layers, bf16 weights from one
    seeded init, on the card (kernels) and on the CPU (plain versions).
    Logits within 4 % of their largest magnitude (the bf16 rounding spread
    the CPU parity test sees against the reference,
    tests/test_torch_lm_serve.py), greedy tokens reported."""
    import dataclasses
    from repro_torch import tree as tu
    from repro_torch.configs import smollm_135m
    from repro_torch.models import lm
    from repro_torch.serve.engine import scatter_prefill
    cfg = smollm_135m.config()
    seg = ((cfg.stack.segments[0][0], layers),)
    cfg = dataclasses.replace(cfg, stack=dataclasses.replace(
        cfg.stack, segments=seg))
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
    check(launches["flash_decode"] == n_layers * runs["decode"],
          f"flash_decode launches {launches} vs {runs}")
    check(launches["qdq_cast"] == len(_lm_leaves()),
          f"qdq_cast launches {launches} vs the tier-0 leaves")
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

    def family(n):
        if "decode_kernel" in n:
            return "flash_decode (this port's kernel)"
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

    def run():
        for _ in range(steps):
            sess.step()

    _profile(run, steps, family,
             f"{steps} decode steps at rung {sess.rung} tier {sess.tier}")
    sess.run()


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
    bw, f32_ops, tc_ops = peaks(name)
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

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    view = resnet18_view()
    res = {"fused_stats": check_stats(view, dev, bw, f32_ops),
           "fused_apply": check_apply_main(view, dev, bw, f32_ops)}
    res["fused_apply"]["max_abs_err"] = max(res["fused_apply"]["max_abs_err"],
                                            check_apply_variants(dev))
    res["qdq_cast"] = check_qdq(dev, bw, f32_ops)
    res["flash_attention"] = check_flash(dev, bw, tc_ops)
    res["flash_decode"] = check_decode(dev, bw, tc_ops)
    log(f"kernel checks in {time.perf_counter() - t_phase:.1f} s")
    if args.kernels_only:
        return 0

    t_phase = time.perf_counter()
    check_step_against_cpu()
    check_lm_against_cpu()
    log(f"card-vs-CPU checks in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    launches = main_path(args.steps, args.batch0)
    sess, serve_launches = serve_main_path()
    for k in ("qdq_cast", "flash_attention", "flash_decode"):
        launches[k] = serve_launches[k]
    log(f"main paths in {time.perf_counter() - t_phase:.1f} s")
    profile_steps(args.batch0)
    profile_decode(sess)

    rows = []
    for kname, (src, replaces) in KERNELS.items():
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kname],
                     **res[kname]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
