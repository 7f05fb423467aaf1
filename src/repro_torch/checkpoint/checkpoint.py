"""Fault-tolerant checkpointing in the reference's on-disk format: atomic,
durable, async, keep-N, device-agnostic.

Layout (one directory per step), byte for byte ``repro.checkpoint``'s:

    <dir>/step_000001230/
        manifest.json        # keypath -> {file, shape, dtype, crc32}
        0000.npy, 0001.npy ...
    <dir>/step_000001230.COMMITTED   # marker written LAST (atomicity)

Manifest keys are ``jax.tree_util.keystr`` paths (``tree.keystrs``:
``.params['bn_stem']['bias']``, ``.control.codes``), leaves are host
``.npy`` files and dtypes numpy's names, so a checkpoint written by either
package restores in the other. bfloat16 and float8_e4m3fn leaves, which
numpy has no type for, are written as the reference's ``np.save`` of an
``ml_dtypes`` array writes them (header descr ``'<V2'`` / ``'<V1'``, then
the raw bits) and come back through an integer view by the manifest's
dtype name. ``restore_checkpoint`` puts each leaf on ``device`` (or on its
template leaf's device), so a checkpoint written on the card restores on
the CPU and the other way round.

Durability and integrity as the reference: every leaf file and the
manifest are fsync'd, the directory entries are fsync'd after the rename,
and the marker is written tmp-file + rename, so a committed marker implies
the bytes under it survived. Each leaf's CRC32 over its exact file bytes
is in the manifest and verified on restore; a generation that fails
verification is skipped with a warning and the newest older generation
that verifies is restored instead.

``AsyncCheckpointer`` copies the state to the host before ``save``
returns (a consistent snapshot: the trainer's tree-form state is views of
its slabs, which the next step overwrites) and writes the files on a
background thread. A failure there is re-raised at the next
``save()``/``wait()``.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.bridge import _NARROW

#: the float dtypes numpy has no type for (``bridge._NARROW`` reads them
#: back): torch dtype -> (manifest dtype name, the integer type of its bits)
_NARROW_TORCH = {torch.bfloat16: ("bfloat16", torch.int16),
                 torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8)}


class CheckpointCorruptError(RuntimeError):
    """A committed generation failed verification (CRC mismatch, truncated
    or missing leaf, unreadable or incomplete manifest)."""


def _fsync_dir(path: str) -> None:
    """fsync a directory's entries (rename durability); skipped where the
    platform refuses a directory fd."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# A host leaf: (C-contiguous numpy array, manifest dtype name). A narrow
# float leaf's array holds its bits as an integer type.
_HostLeaf = Tuple[np.ndarray, str]


def _host_leaf(x: torch.Tensor) -> _HostLeaf:
    """One tensor on any device -> a host copy that owns its memory,
    complete on return."""
    x = x.detach()
    narrow = _NARROW_TORCH.get(x.dtype)
    if narrow is not None:
        x = x.view(narrow[1])
    a = x.contiguous().to("cpu", copy=True).numpy()
    return a, (narrow[0] if narrow is not None else str(a.dtype))


def _host_leaves(state: Any) -> List[Tuple[str, _HostLeaf]]:
    return [(k, _host_leaf(x))
            for k, x in zip(tu.keystrs(state), tu.leaves(state))]


def _npy_bytes(arr: np.ndarray, dtype: str) -> bytes:
    """The file ``np.save`` writes for this leaf in the reference: a narrow
    float leaf as raw void items of its width."""
    buf = io.BytesIO()
    if dtype in _NARROW:
        np.lib.format.write_array_header_1_0(buf, {
            "descr": f"<V{arr.dtype.itemsize}", "fortran_order": False,
            "shape": tuple(int(n) for n in arr.shape)})
        buf.write(arr.tobytes())
    else:
        np.save(buf, arr)
    return buf.getvalue()


def _write(directory: str, step: int, leaves, keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:012d}"
    tmp = os.path.join(directory, f".tmp_{name}")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    for i, (key, (arr, dtype)) in enumerate(leaves):
        fn = f"{i:04d}.npy"
        # the manifest CRC covers the exact bytes on disk (header included)
        data = _npy_bytes(arr, dtype)
        with open(os.path.join(tmp, fn), "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        manifest[key] = {"file": fn, "shape": list(arr.shape),
                         "dtype": dtype, "crc32": zlib.crc32(data)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(directory)            # the rename itself must survive
    # marker via tmp + rename, after the data and the directory entry: a
    # reader never sees a torn marker, and a marker is an honest commit
    marker = final + ".COMMITTED"
    mtmp = marker + ".tmp"
    with open(mtmp, "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.rename(mtmp, marker)
    _fsync_dir(directory)
    _gc(directory, keep)
    return final


def save_checkpoint(directory: str, step: int, state: Any,
                    keep: int = 3) -> str:
    """Write ``state`` (a tree of tensors on any device) as generation
    ``step`` and keep the newest ``keep``."""
    return _write(directory, step, _host_leaves(state), keep)


def _gc(directory: str, keep: int):
    steps = sorted(_committed_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        name = f"step_{s:012d}"
        shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
        try:
            os.remove(os.path.join(directory, name + ".COMMITTED"))
        except OSError:
            pass


def _committed_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for fn in os.listdir(directory):
        if fn.endswith(".COMMITTED"):
            try:
                out.append(int(fn[len("step_"):-len(".COMMITTED")]))
            except ValueError:
                pass
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _committed_steps(directory)
    return max(steps) if steps else None


def _read_manifest(directory: str, step: int) -> Dict[str, Any]:
    d = os.path.join(directory, f"step_{step:012d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)["leaves"]
    except (OSError, ValueError, KeyError) as e:
        raise CheckpointCorruptError(
            f"step {step}: unreadable manifest ({e})") from e


def manifest_keys(directory: str, step: Optional[int] = None):
    """Saved keypaths of a committed checkpoint, so a reader detects the
    on-disk schema (4-field vs 5-field states) from the manifest. With
    ``step=None`` the newest generation whose manifest is readable
    answers."""
    if step is not None:
        return sorted(_read_manifest(directory, step).keys())
    steps = sorted(_committed_steps(directory), reverse=True)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    err: Optional[Exception] = None
    for s in steps:
        try:
            return sorted(_read_manifest(directory, s).keys())
        except CheckpointCorruptError as e:
            err = e
    raise CheckpointCorruptError(
        f"no generation in {directory} has a readable manifest") from err


def _load_leaf(d: str, meta: Dict[str, Any]) -> np.ndarray:
    """Read and verify one leaf file: the CRC (where the manifest records
    one) over the raw bytes before ``np.load`` parses them. A narrow float
    leaf comes back as void items."""
    fn = meta["file"]
    try:
        with open(os.path.join(d, fn), "rb") as f:
            data = f.read()
    except OSError as e:
        raise CheckpointCorruptError(f"{fn}: unreadable ({e})") from e
    crc = meta.get("crc32")
    if crc is not None and zlib.crc32(data) != int(crc):
        raise CheckpointCorruptError(f"{fn}: CRC32 mismatch")
    try:
        arr = np.load(io.BytesIO(data))
    except Exception as e:
        raise CheckpointCorruptError(f"{fn}: corrupt npy ({e})") from e
    if list(arr.shape) != list(meta.get("shape", arr.shape)):
        raise CheckpointCorruptError(
            f"{fn}: shape {list(arr.shape)} != manifest {meta['shape']}")
    return arr


def _tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A loaded leaf -> a tensor on ``device`` with the same bits (the
    array np.load returns is read-only: the tensor gets its own copy)."""
    if arr.dtype.kind == "V":
        if dtype not in _NARROW:
            raise ValueError(f"no torch dtype for the void leaf {dtype!r}")
        npi, tdt = _NARROW[dtype]
        return torch.from_numpy(arr.view(npi).copy()).view(tdt).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def _fill_for(key: str, fill_missing) -> Optional[np.ndarray]:
    """Fill for a leaf ABSENT from the manifest, matched by key substring
    (``{"lr_demote": np.ones(())}`` fills ``.control.lr_demote``): schema
    evolution, told apart from corruption, where a missing key without a
    fill falls back a generation."""
    if not fill_missing:
        return None
    for frag, val in fill_missing.items():
        if frag in key:
            return np.asarray(val)
    return None


def _leaf_device(leaf: torch.Tensor, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return leaf.device if leaf.device.type != "meta" else torch.device("cpu")


def _restore_step(directory: str, step: int, template: Any, device,
                  fill_missing) -> Any:
    d = os.path.join(directory, f"step_{step:012d}")
    manifest = _read_manifest(directory, step)
    leaves, treedef = tu.flatten(template)
    out = []
    for key, leaf in zip(tu.keystrs(template), leaves):
        meta = manifest.get(key)
        if meta is None:
            arr = _fill_for(key, fill_missing)
            if arr is None:
                # a DAMAGED manifest leaves leaf files on disk it no longer
                # references (falls back a generation); an OLDER schema is
                # consistent, files == entries (KeyError, for the caller's
                # schema fallback)
                listed = {m.get("file") for m in manifest.values()}
                on_disk = {fn for fn in os.listdir(d) if fn.endswith(".npy")}
                if on_disk - listed:
                    raise CheckpointCorruptError(
                        f"manifest missing entry for {key} while "
                        f"unreferenced leaf files exist")
                raise KeyError(key)
            dtype = str(arr.dtype)
        else:
            arr = _load_leaf(d, meta)
            dtype = meta.get("dtype", str(arr.dtype))
        out.append(_tensor(arr, dtype, _leaf_device(leaf, device)))
    return tu.unflatten(treedef, out)


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None, device=None,
                       fill_missing=None) -> Any:
    """Restore into ``template``'s tree structure (its leaves may be meta
    tensors: only their key paths and, without ``device``, their devices
    are read). Each leaf keeps its saved dtype and lands on ``device``, or
    else on its template leaf's device (the CPU for a meta leaf).

    Every leaf is CRC-verified. With ``step=None`` a generation that fails
    verification is skipped with a ``RuntimeWarning`` and the newest older
    one that verifies is restored; an explicit ``step`` raises
    ``CheckpointCorruptError`` instead. ``fill_missing`` maps key
    substrings to values for leaves the manifest predates; a missing key
    without a fill raises ``KeyError`` (the older generations share the
    schema, so none is tried)."""
    if step is not None:
        return _restore_step(directory, step, template, device,
                             fill_missing)
    steps = sorted(_committed_steps(directory), reverse=True)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    last_err: Optional[Exception] = None
    for s in steps:
        try:
            return _restore_step(directory, s, template, device,
                                 fill_missing)
        except CheckpointCorruptError as e:
            warnings.warn(
                f"checkpoint step {s} failed verification ({e}); "
                f"falling back to an older generation", RuntimeWarning)
            last_err = e
    raise CheckpointCorruptError(
        f"no committed generation in {directory} verifies") from last_err


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at most one save in flight.
    ``save`` returns once the state is on the host; a failed background
    write is re-raised at the next ``save()``/``wait()``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_saved: Optional[int] = None

    def save(self, step: int, state: Any, block: bool = False):
        self.wait()
        host = _host_leaves(state)     # device -> host, complete on return

        def _run():
            try:
                _write(self.directory, step, host, self.keep)
                self.last_saved = step
            except BaseException as e:       # surfaced by the next call
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"background checkpoint save to {self.directory} failed"
            ) from err
