#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # from the repository root

Phases (any failure raises and the script exits non-zero):

  1. the card (``nvidia-smi``), torch and CUDA versions;
  2. build every CUDA source under ``src/repro_torch/kernels/csrc`` with
     ``nvcc`` (all sources at once), print the seconds and the ptxas report;
  3. hold each kernel against its plain PyTorch version on the card: at the
     ResNet-18 slab shape of the main path (22,016 x 512, 11 layers, random
     data with inf/NaN lanes) and over every ``fused_apply`` variant on a
     small slab; time the kernel and the plain version with CUDA events and
     compute the least time the card could take (``bound_ms``);
  4. a correctness check of the whole step: one slab-resident train step
     of ResNet-18 at batch 4 on the card (kernels) against the same step on
     the CPU (plain versions), from the same weights and batch;
  5. the main path: ``run_method("triaccel", "resnet18", steps=50,
     batch0=32, device="cuda")``, with the kernels' launch counts read
     around it;
  6. where a step's time goes: ``torch.profiler`` over a few steps of the
     same trainer, device time by kernel family and the idle share.

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

import torch

ROOT = Path(__file__).resolve().parent
CSRC = "src/repro_torch/kernels/csrc"
# (name, CUDA source, the Pallas call it replaces)
KERNELS = {
    "fused_stats": (f"{CSRC}/fused_update.cu",
                    "src/repro/kernels/fused_update.py:122"),
    "fused_apply": (f"{CSRC}/fused_update.cu",
                    "src/repro/kernels/fused_update.py:317"),
}
# published peaks of the H100 SXM (NVIDIA's data sheet): device memory
# bytes/s and f32 operations/s outside the tensor cores
PEAKS = {"H100": (3.35e12, 67e12)}


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


def bound(nbytes: float, nops: float, bw: float, f32_ops: float):
    """-> (least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / bw, nops / f32_ops
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
        else:        # another summation order: rtol 1e-5
            check(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
                  f"fused_stats {n}: {a} vs {b}")
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
            "bound_ms": b_ms, "bound_by": by}


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
            "bound_ms": b_ms, "bound_by": by}


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


def profile_steps(batch0: int, warm: int = 6, steps: int = 5) -> None:
    """Where a step's time goes: ``torch.profiler`` over ``steps`` steps of
    the main path's trainer after ``warm`` steps, device time by kernel
    family and the device's idle share of the host's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.paper_harness import make_trainer
    trainer = make_trainer("triaccel", "resnet18", steps=50, batch0=batch0,
                           device="cuda")[0]
    trainer.run(warm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.events() if e.device_type == cuda]
    fam = {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, end = 0.0, -1.0
    for a, b in spans:                   # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    for e in kern:
        n = e.name.lower()
        key = ("fused update (this port's kernels)"
               if "stats_partials" in n or "apply_kernel" in n
               or "reduce_partials" in n else
               "convolution / matmul" if any(
                   w in n for w in ("conv", "gemm", "xmma", "cudnn", "wgrad",
                                    "dgrad", "cutlass", "sm90")) else
               "memcpy / memset" if "memcpy" in n or "memset" in n else
               "reduction" if "reduce" in n else "elementwise / other")
        fam[key] = fam.get(key, 0.0) + (e.time_range.end
                                        - e.time_range.start)
    log(f"profile, {steps} steps at rung {trainer.scaler.microbatch}: host "
        f"{wall_us / steps / 1e3:.3f} ms a step, device busy "
        f"{busy / steps / 1e3:.3f} ms a step, idle share "
        f"{1 - busy / wall_us:.3f}; {len(kern) / steps:.0f} device ops a "
        "step")
    for k, v in sorted(fam.items(), key=lambda kv: -kv[1]):
        log(f"  {k}: {v / steps / 1e3:.3f} ms a step")
    top = {}
    for e in kern:
        top[e.name] = top.get(e.name, 0.0) + (e.time_range.end
                                              - e.time_range.start)
    for n, v in sorted(top.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {v / steps / 1e3:8.3f} ms  {n[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch0", type=int, default=32)
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
    bw, f32_ops = peaks(name)
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
        log(f"  ptxas {s}: {len(regs)} kernels, at most {max(regs)} "
            f"registers a thread, {spills} bytes of spills")

    dev = torch.device("cuda")
    view = resnet18_view()
    stats = check_stats(view, dev, bw, f32_ops)
    apply_ = check_apply_main(view, dev, bw, f32_ops)
    apply_["max_abs_err"] = max(apply_["max_abs_err"],
                                check_apply_variants(dev))
    check_step_against_cpu()
    launches = main_path(args.steps, args.batch0)
    profile_steps(args.batch0)

    rows = []
    for kname, res in (("fused_stats", stats), ("fused_apply", apply_)):
        src, replaces = KERNELS[kname]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kname],
                     **res, "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
