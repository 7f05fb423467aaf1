#!/usr/bin/env python3
"""Design variants of the tier-cast kernel (``csrc/qdq_cast.cu``), timed on
one GPU: each variant is the source with one choice undone, built beside
the shipped one, and both forms are timed over each leaf of smollm-135m
(f32 in and out, each leaf's absmax given to the one-pass form) by the
profiler's device time, beside ``torch.amax`` (one read of x) and
``torch.clone`` (one read and one write). The fp8 conversion's choice
(``tier_round.cuh``, shared with ``csrc/fused_update.cu``) is also timed
in ``fused_apply`` at smollm-135m's slab on the tpu ladder, each build
checked bitwise against the plain version.

    python3 chip_qdq_variants.py        # from the repository root

Variants: ``shipped``; ``chunked`` (each block one contiguous chunk of
rows, instead of rows dealt in turn); ``hold0`` (no rows kept in shared
memory between the passes); ``plain_st`` / ``plain_ld`` (ordinary stores /
phase-2 loads instead of evict-first); ``capped`` (the one-pass grid
capped at what is resident, as the two-pass grid); ``unroll4`` (four units
a thread in flight); ``nosat`` (fp8 converted with ``__NV_NOSAT`` instead
of ``__NV_SATFINITE``). Prints tables; needs a card and ``nvcc``.

A one-off record of the design's choices: each variant edits the sources
by exact text, so once they drift the script stops with the text it
missed, and it is then deleted rather than kept in step.
"""
from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src/repro_torch/kernels/csrc"
LAYOUT = '''  const long stride = (long)gridDim.x * THREADS;
  const long lo = (long)blockIdx.x * THREADS, hi = g.units;
  const long steps = (g.units + stride - 1) / stride;'''
CHUNKED = '''  const long per = (g.units + gridDim.x - 1) / gridDim.x;
  const long lo = lmin((long)blockIdx.x * per, g.units);
  const long hi = lmin(lo + per, g.units);
  const long stride = THREADS;
  const long steps = (hi - lo + THREADS - 1) / THREADS;'''
NOSAT = ("__NV_SATFINITE, __NV_E4M3", "__NV_NOSAT, __NV_E4M3")
VARIANTS = {
    "shipped": {},
    "chunked": {LAYOUT: CHUNKED},
    "hold0": {"constexpr int HOLD = 11;": "constexpr int HOLD = 0;"},
    "plain_st": {"  __stcs(p, v);": "  *p = v;"},
    "plain_ld": {"LAST ? __ldcs(p) : __ldg(p)": "__ldg(p)",
                 "LAST ? __ldcs(q) : __ldg(q)": "__ldg(q)"},
    "capped": {"(TWO_PASS && want > cap ? cap : want)":
               "(want > cap ? cap : want)"},
    "unroll4": {"constexpr int UNROLL = 2;": "constexpr int UNROLL = 4;"},
    "nosat": {NOSAT[0]: NOSAT[1]},
}


def _nvcc(name: str, src: str, subs: dict, out: Path):
    """Start nvcc on ``csrc/<src>.cu`` with ``subs`` applied to it and to
    the headers beside it (each text must be found in one of them), in a
    directory of the variant's own -> (process, library path)."""
    from repro_torch.kernels import _build
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    texts = {p.name: p.read_text() for p in [CSRC / f"{src}.cu",
                                            *CSRC.glob("*.cuh")]}
    for old in subs:
        if not any(old in t for t in texts.values()):
            raise RuntimeError(f"{name}: {old!r} not in the sources")
    for fname, text in texts.items():
        for old, new in subs.items():
            text = text.replace(old, new)
        (d / fname).write_text(text)
    so = d / f"lib{src}.so"
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.flags(src), "-o", str(so),
         str(d / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def _finish(name, proc, so) -> ctypes.CDLL:
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)})
    print(f"{name}: registers {regs}", flush=True)
    return ctypes.CDLL(str(so))


def build(out: Path):
    """Every variant's library, built in parallel -> ({name: CDLL} of the
    tier cast, {name: CDLL} of the fused update, shipped and nosat)."""
    procs = {name: _nvcc(name, "qdq_cast", subs, out)
             for name, subs in VARIANTS.items()}
    fprocs = {name: _nvcc(f"fused_update_{name}", "fused_update", subs, out)
              for name, subs in (("shipped", {}),
                                 ("nosat", VARIANTS["nosat"]))}
    libs = {}
    for name, (proc, so) in procs.items():
        lib = _finish(name, proc, so)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.tri_qdq_cast.argtypes = [P, I, P, I, L, I, I, P, I, P, I, P]
        lib.tri_qdq_cast.restype = I
        lib.tri_qdq_cast_max_grid.restype = I
        print(f"  largest two-pass grid {lib.tri_qdq_cast_max_grid()}",
              flush=True)
        libs[name] = lib
    return libs, {name: _finish(f"fused_update {name}", proc, so)
                  for name, (proc, so) in fprocs.items()}


def time_fused_apply(cs, flibs) -> None:
    """fused_apply at smollm-135m's slab (the LM path's variant on the tpu
    ladder, where the fp8 conversion runs) with each build of the header,
    in turns, each checked bitwise against the plain version."""
    from repro_torch.kernels import _build
    bw, f32_ops, _ = cs.peaks(torch.cuda.get_device_name(0))
    view = cs.lm_train_view()
    kw = {**cs.lm_train_variant(), "ladder": "tpu"}
    res = {}
    for _ in range(2):
        for name, lib in flibs.items():
            _build._LIBS["fused_update"] = lib
            r = cs.check_apply_main(view, torch.device("cuda"), bw, f32_ops,
                                    what=f"smollm-135m, {name}", **kw)
            res.setdefault(name, []).append(r["ms"])
    _build._LIBS.pop("fused_update", None)
    print("fused_apply, smollm-135m slab, tpu ladder, ms by events, two "
          "rounds: " + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}"
                                 for k, v in res.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_qdq_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    libs, flibs = build(ROOT / "build" / "qdq_variants")
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = cs._lm_leaves()
    xs = [torch.randn(s, generator=gen, device="cuda") * 0.05
          for s in shapes]
    outs = [torch.empty_like(x) for x in xs]
    amaxes = [x.abs().amax() for x in xs]
    stream = torch.cuda.current_stream().cuda_stream
    grid = max(lib.tri_qdq_cast_max_grid() for lib in libs.values())
    part = torch.empty((grid,), dtype=torch.int32, device="cuda")

    def run(lib, idx, given):
        def fn():
            for k in idx:
                x, o, a = xs[k], outs[k], amaxes[k]
                rc = lib.tri_qdq_cast(
                    x.data_ptr(), 0, o.data_ptr(), 0, x.numel(), 0, 1,
                    a.data_ptr() if given else None, int(not given),
                    part.data_ptr(), grid, stream)
                if rc:
                    raise RuntimeError(f"cudaError {rc}")
        return fn

    # every variant bitwise equal to the shipped kernel, both forms, on
    # values past fp8's range at the scale (amax given at a quarter of the
    # true one), NaN and inf among them
    z = torch.randn(1 << 20, generator=gen, device="cuda") * 100.0
    z[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    za = z[3:].abs().amax() / 4
    zo = {}
    for name, lib in libs.items():
        for given in (False, True):
            o = torch.empty_like(z)
            rc = lib.tri_qdq_cast(
                z.data_ptr(), 0, o.data_ptr(), 0, z.numel(), 0, 1,
                za.data_ptr() if given else None, int(not given),
                part.data_ptr(), grid, stream)
            if rc:
                raise RuntimeError(f"{name}: cudaError {rc}")
            zo[(name, given)] = o.view(torch.int32)
    for (name, given), o in zo.items():
        if not torch.equal(o, zo[("shipped", given)]):
            raise RuntimeError(f"{name}: not bitwise the shipped kernel")
    print("every variant bitwise equal to the shipped kernel, both forms",
          flush=True)

    groups = {"all 11 leaves": list(range(len(xs)))}
    for k, s in enumerate(shapes):
        groups.setdefault(str(s), []).append(k)
    res = {}
    for _ in range(2):                  # two rounds, variants in turn
        for name, lib in libs.items():
            for g, idx in groups.items():
                for given in (False, True):
                    res.setdefault((name, g, given), []).append(
                        cs.device_ms(run(lib, idx, given), iters=10))
    print("device ms (profiler), mean of 2 rounds: two-pass / one-pass")
    for g, idx in groups.items():
        mb = sum(xs[k].numel() for k in idx) * 4 / 1e6
        read = cs.device_ms(lambda: [torch.amax(xs[k]) for k in idx], 10)
        copy = cs.device_ms(lambda: [xs[k].clone() for k in idx], 10)
        print(f"{g}, {len(idx)} leaf(s), {mb:.1f} MB: torch.amax {read:.4f}"
              f", torch.clone {copy:.4f}")
        for name in libs:
            two = statistics.mean(res[(name, g, False)])
            one = statistics.mean(res[(name, g, True)])
            print(f"  {name:9s} {two:.4f} / {one:.4f}")
    time_fused_apply(cs, flibs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
