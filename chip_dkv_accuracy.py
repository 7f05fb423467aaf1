#!/usr/bin/env python3
"""The flash backward's accuracy on the card against an f64 backward, at
long GQA sums (the shapes recurrentgemma-2b trains at) and beside them;
with ``--time``, the tensor-core dQ and dK/dV kernels' times at the
models' training shapes instead.

    python3 chip_dkv_accuracy.py
    python3 chip_dkv_accuracy.py --time

For each shape (B, S, q heads / kv heads, head dim 256, window) it draws
bf16 q, k, v and dO from a seed, takes the LSE and delta from the plain
forward, and runs the tensor-core dQ and dK/dV kernels
(``flash_attention.flash_bwd_dq_cuda`` / ``flash_bwd_dkv_cuda``) and their
plain versions. It computes the same backward in f64 from the same
inputs, LSE and delta, and prints for dQ, dK and dV: the largest |f64|,
the kernel's and the plain version's largest gap to it as a share of
that, and how many elements lie outside ``flash_attention.tolerance``:
kernel against plain version, kernel against the f64 backward, plain
version against it. With ``--time`` it prints ``flash_bwd_sm90``'s
registers and spill stores a kernel (its build's ptxas report), then for
each of ``TIME_SHAPES`` whether the dK/dV kernel splits by q head and the
median of ``REPS`` CUDA-event times of each kernel, beside the card's
name and power limit. It runs the ``src`` beside it, so a copy of the
script in another checkout times that checkout's kernels. Needs one CUDA
card; builds the kernels at first use.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import torch

#: (B, S, H, K, D, window): recurrentgemma-2b's training shape, unwindowed
#: and at S 2048, gemma3-4b's (rep 2), and rep 1 at S 4096
SHAPES = ((2, 4096, 10, 1, 256, 2048), (2, 4096, 10, 1, 256, 0),
          (2, 2048, 8, 4, 256, 0), (2, 2048, 8, 4, 256, 1024),
          (2, 4096, 10, 10, 256, 2048), (2, 2048, 10, 1, 256, 0))

#: (model, B, S, H, K, D, Dv, window): the training shapes of phases 12-14
#: of chip_smoke.py (stablelm-1.6b, minitron-4b, gemma3-4b global and
#: local, deepseek-v2-lite-16b, recurrentgemma-2b)
TIME_SHAPES = (("stablelm-1.6b", 2, 1024, 32, 32, 64, 64, 0),
               ("minitron-4b", 2, 1024, 24, 8, 128, 128, 0),
               ("gemma3-4b", 2, 2048, 8, 4, 256, 256, 0),
               ("gemma3-4b local", 2, 2048, 8, 4, 256, 256, 1024),
               ("deepseek-v2-lite-16b", 2, 1024, 16, 16, 192, 128, 0),
               ("recurrentgemma-2b", 2, 4096, 10, 1, 256, 256, 2048))
#: timed calls a kernel, after two untimed
REPS = 20


def f64_backward(q, k, v, do, lse, delta, window):
    """(dq, dk, dv) in f64 from the given LSE and delta."""
    B, S, H, D = q.shape
    K = k.shape[2]
    r = H // K
    qd = q.double().reshape(B, S, K, r, D) * D ** -0.5
    kd, vd = k.double(), v.double()
    dod = do.double().reshape(B, S, K, r, -1)
    s = torch.einsum("bqkrd,bskd->bqkrs", qd, kd)
    i = torch.arange(S, device=q.device)
    ok = i[None, :] <= i[:, None]
    if window:
        ok = ok & (i[:, None] - i[None, :] < window)
    p = torch.exp(s - lse.double().permute(0, 2, 1).reshape(B, S, K, r, 1))
    p = p * ok[None, :, None, None, :]
    dp = torch.einsum("bqkrd,bskd->bqkrs", dod, vd)
    ds = p * (dp - delta.double().permute(0, 2, 1).reshape(B, S, K, r, 1))
    dk = torch.einsum("bqkrs,bqkrd->bskd", ds, qd)
    dv = torch.einsum("bqkrs,bqkrd->bskd", p, dod)
    dq = torch.einsum("bqkrs,bskd->bqkrd", ds, kd).reshape(q.shape)
    return dq * D ** -0.5, dk, dv


def median_ms(fn) -> float:
    """The median of ``REPS`` CUDA-event times of ``fn()``, in ms."""
    for _ in range(2):
        fn()
    ts = []
    for _ in range(REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def time_kernels(fa, dev) -> None:
    from repro_torch.kernels import _build
    fa._tc_bwd_lib()
    for line in _build.BUILD_LOG.get("flash_bwd_sm90", "").splitlines():
        if "registers" in line or "spill stores" in line or (
                "Compiling entry" in line):
            print("  ptxas " + line.strip(), flush=True)
    split_of = getattr(fa, "dkv_workspace", None)
    gen = torch.Generator(device=dev).manual_seed(17)
    for name, B, S, H, K, D, Dv, w in TIME_SHAPES:
        q, k, v, do = (torch.randn(sh, generator=gen, device=dev).bfloat16()
                       for sh in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv),
                                  (B, S, H, Dv)))
        kw = dict(causal=True, window=w)
        o, lse = fa.flash_attention_ref(q, k, v, None, with_lse=True, **kw)
        delta = fa.flash_bwd_delta_ref(o, do)
        split = ("n/a" if split_of is None
                 else split_of(k, v, H)[0] is not None)
        dkv = median_ms(lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse,
                                                      delta, **kw))
        dq = median_ms(lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                    **kw))
        print(f"{name}: B{B} S{S} {H}/{K} D{D}/{Dv} window {w}: split "
              f"{split}; dK/dV {dkv:.4f} ms, dQ {dq:.4f} ms (median of "
              f"{REPS})", flush=True)
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_dkv_accuracy: no CUDA card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; kernels of {root}", flush=True)
    if "--time" in sys.argv[1:]:
        time_kernels(fa, dev)
        return 0
    gen = torch.Generator(device=dev).manual_seed(17)
    for B, S, H, K, D, w in SHAPES:
        q, k, v, do = (torch.randn(sh, generator=gen, device=dev).bfloat16()
                       for sh in ((B, S, H, D), (B, S, K, D), (B, S, K, D),
                                  (B, S, H, D)))
        kw = dict(causal=True, window=w)
        o, lse = fa.flash_attention_ref(q, k, v, None, with_lse=True, **kw)
        delta = fa.flash_bwd_delta_ref(o, do)
        dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
        dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
        dk_r, dv_r = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
        dq_r = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
        truth = f64_backward(q, k, v, do, lse, delta, w)
        out = []
        for n, a, b, t in zip(("dq", "dk", "dv"), (dq, dk, dv),
                              (dq_r, dk_r, dv_r), truth):
            m = float(t.abs().max())
            over = lambda x, y: int(  # noqa: E731
                ((x.double() - y.double()).abs()
                 > fa.tolerance(x, y.to(x.dtype)).double()).sum())
            out.append(
                f"{n}: max|f64| {m:.3g}, kernel {float((a.double() - t).abs().max()) / m:.3g}"
                f", plain {float((b.double() - t).abs().max()) / m:.3g} of it; "
                f"outside tolerance: kernel vs plain {over(a, b)}, kernel "
                f"vs f64 {over(a, t)}, plain vs f64 {over(b, t)}")
        print(f"B{B} S{S} {H}/{K} D{D} window {w}: " + "; ".join(out),
              flush=True)
        del q, k, v, do, o, lse, delta, dk, dv, dq, dk_r, dv_r, dq_r, truth
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
