"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded through ``ctypes`` — no PyTorch headers,
so a build takes seconds. Libraries go to ``<repo>/build/`` (listed in
``.gitignore``), named by a hash of the source, its headers and flags, so
an edited source rebuilds and an unchanged one is reused. Nothing here
runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: flags of one source beyond ``NVCC_FLAGS``. No a*b+c contraction for the
#: kernels held bitwise against their plain PyTorch versions, which round
#: after every operation; the attention kernels are held to a tolerance
#: and keep nvcc's fused multiply-adds.
SOURCE_FLAGS = {"fused_update": ["--fmad=false"],
                "qdq_cast": ["--fmad=false"]}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) per built source
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def flags(name: str) -> List[str]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])


def lib_path(name: str) -> Path:
    """The library's path, named by a hash of the source, the headers
    beside it and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def start_build(name: str) -> Optional[subprocess.Popen]:
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library exists;
    returns the process (or None). Lets a caller build several sources in
    parallel, then ``load`` each."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags(name), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp_path = tmp                     # type: ignore[attr-defined]
    proc.out_path = out                     # type: ignore[attr-defined]
    return proc


def finish_build(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(proc.tmp_path, proc.out_path)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            finish_build(name, start_build(name))
            lib = ctypes.CDLL(str(lib_path(name)))
            _LIBS[name] = lib
        return lib
