"""Flash attention: the prefill forward (causal, static window, optional
segments, optional LSE residual), its backward (delta, dQ, dK/dV from the
saved LSE) and the ragged single-token decode.

Two forms of each: the hand-written CUDA kernels for Hopper
(``csrc/flash_fwd_sm90.cu``, ``csrc/flash_attention.cu``,
``csrc/flash_bwd_sm90.cu``, ``csrc/flash_bwd_tf32.cu``,
``csrc/flash_attention_bwd.cu`` and ``csrc/flash_decode_sm90.cu``, bound
through ``ctypes``: ``*_cuda``) and
their plain PyTorch versions
(``*_ref``), which mirror ``repro/kernels/ref.py`` (full softmax with the
finite ``NEG_INF``) and, for the backward, the math of the reference's
Pallas backward over full (S, S) matrices in f32. ``kernels.ops`` routes a
CPU tensor to the plain version and a CUDA tensor to the kernel, behind
the reference's dispatch gates.

Shapes: q (B, S, H, D); k (B, S, K, D); v (B, S, K, Dv); H % K == 0 (GQA:
q head h reads kv head h // (H/K)). Decode: q (B, 1, H, D) against a
(B, L, K, D) / (B, L, K, Dv) cache; row b attends slots [0, lengths[b]).
A row of length 0 gives zeros, as the reference kernel's
``l = max(l, 1e-30)`` clamp gives (the reference's full-softmax oracle
would average V there; the kernels are what the JAX package runs).

The forward has two kernels, and ``fwd_route`` picks one from the dtype
and the head dims alone: bf16 with D and Dv multiples of 16 up to 256 runs
the tensor-core kernel (``flash_fwd_sm90.cu``: wgmma, TMA), everything
else the f32 SIMT kernel (``flash_attention.cu``). The backward's dQ and
dK/dV pick one of three through ``bwd_route``: bf16 at the forward's
tensor-core head dims takes the tensor-core kernels of
``flash_bwd_sm90.cu``; f32 with D and Dv multiples of 8 up to 256 the
split-TF32 tensor-core kernels of ``flash_bwd_tf32.cu`` (each f32 operand
as a tf32 hi + lo pair, three products for one: f32 accuracy); everything
else the SIMT kernels of ``flash_attention_bwd.cu``, which also hold delta
on every route. The
decode splits each (row, kv head)'s live keys over a cluster of
``DECODE_CLUSTER`` blocks (``flash_decode_sm90.cu``); ``decode_geometry``
and ``delta_geometry`` size the decode's shared ring and delta's blocks
from the shapes alone. A launch or build error raises; nothing switches
route on a failure.

``BQ``, ``BK`` and ``DECODE_BLOCKS`` are the reference's tile sizes. The
port keeps them for its gates, so it takes a kernel exactly where the
reference does; the CUDA kernels tile by 64 inside (the SIMT and split-TF32
backward by 32 above head dim 128, ``bwd_rows``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38
BQ = 256
BK = 256
#: candidate k-block sizes of the reference's ragged decode kernel; its gate
#: takes the kernel only where one of them tiles the cache length
DECODE_BLOCKS = (256, 128, 64, 32, 16, 8)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the CUDA kernels' query tile (rows a block); S must be a multiple
CUDA_BQ = 64
MAX_HEAD_DIM = 256
#: the backward kernels take every head dim the forward takes
BWD_MAX_HEAD_DIM = MAX_HEAD_DIM
#: dynamic shared memory a block may use on the H100
SMEM_LIMIT = 232_448


def fwd_route(dtype, D: int, Dv: int) -> str:
    """Which forward kernel a CUDA call runs: "tc" (``flash_fwd_sm90.cu``,
    bf16 tensor cores) for bf16 with D and Dv multiples of 16 in [16, 256],
    else "simt" (``flash_attention.cu``, f32 on the CUDA cores)."""
    if dtype == torch.bfloat16 and all(
            d % 16 == 0 and 16 <= d <= MAX_HEAD_DIM for d in (D, Dv)):
        return "tc"
    return "simt"


def bwd_route(dtype, D: int, Dv: int) -> str:
    """Which dQ and dK/dV kernels a CUDA call runs, from the dtype and the
    head dims alone: "tc" (``flash_bwd_sm90.cu``, bf16 tensor cores) where
    ``fwd_route`` says "tc" (bf16, D and Dv multiples of 16 in [16, 256]);
    "tf32" (``flash_bwd_tf32.cu``, f32 on the tensor cores in split TF32)
    for f32 with D and Dv multiples of 8 in [8, 256]; else "simt"
    (``flash_attention_bwd.cu``, f32 arithmetic on the CUDA cores)."""
    if fwd_route(dtype, D, Dv) == "tc":
        return "tc"
    if dtype == torch.float32 and all(
            d % 8 == 0 and 8 <= d <= BWD_MAX_HEAD_DIM for d in (D, Dv)):
        return "tf32"
    return "simt"


def bwd_rows(D: int, Dv: int) -> int:
    """Row tile of the SIMT and split-TF32 dQ and dK/dV kernels: 64 up to
    head dim 128, 32 above, so that their shared-memory tiles fit
    (``bwd_smem``, ``bwd_tf32_smem``)."""
    return 64 if max(D, Dv) <= 128 else 32


def bwd_smem(kernel: str, D: int, Dv: int, rows: int) -> int:
    """Dynamic shared memory of a dQ ("dq") or dK/dV ("dkv") block, bytes:
    ``dq_smem`` / ``dkv_smem`` of ``flash_attention_bwd.cu``. Four
    (rows, D+1 or Dv+1) f32 tiles, one (dQ) or two (dK/dV) (rows, rows+1)
    score tiles, the rows' lse and delta, two int32 segment rows."""
    scores = {"dq": 1, "dkv": 2}[kernel]
    floats = (2 * rows * (D + 1) + 2 * rows * (Dv + 1)
              + scores * rows * (rows + 1) + 2 * rows)
    return 4 * floats + 4 * 2 * rows


#: 64 x 64 bf16 box of the tensor-core kernels, and their ring depth
TC_BOX_BYTES, TC_STAGES = 64 * 128, 2


def bwd_tc_smem(kernel: str, D: int, Dv: int) -> int:
    """Dynamic shared memory of a tensor-core dQ ("dq") or dK/dV ("dkv")
    block, bytes: ``dq_tc_smem`` / ``dkv_tc_smem`` of
    ``flash_bwd_sm90.cu``. 1024 bytes of alignment slack, the block's own
    tiles and two ring stages of 64 x 64 bf16 boxes (ceil(D/64) +
    ceil(Dv/64) a tile), the mbarriers, and for dK/dV two stages of lse and
    delta rows."""
    boxes = -(-D // 64) + -(-Dv // 64)
    size = 1024 + TC_BOX_BYTES * (1 + TC_STAGES) * boxes + 8 * (2 * TC_STAGES
                                                                 + 1)
    return size + ({"dq": 0, "dkv": 4 * 2 * TC_STAGES * 64}[kernel])


#: floats of padding a shared row of the split-TF32 kernels, and their ring
#: depth
TF32_PAD, TF32_STAGES = 4, 2


def bwd_tf32_width(D: int, Dv: int) -> int:
    """The width W both head dims are padded to in the split-TF32 kernels
    (``padded_blocks`` of ``flash_bwd_tf32.cu``, times 8): 32, 64, 96 or
    128 on 64-row tiles, 192 or 256 on 32-row tiles."""
    n = -(-max(D, Dv) // 8)
    sizes = (4, 8, 12, 16) if bwd_rows(D, Dv) == 64 else (24, 32)
    return 8 * next(b for b in sizes if n <= b)


def bwd_tf32_smem(kernel: str, D: int, Dv: int) -> int:
    """Dynamic shared memory of a split-TF32 dQ ("dq") or dK/dV ("dkv")
    block, bytes: ``dq_tf32_smem`` / ``dkv_tf32_smem`` of
    ``flash_bwd_tf32.cu`` at the row tile ``bwd_rows`` gives. Three tiles'
    worth (the block's own and two ring stages) of two (rows, W+4) f32
    tiles (``bwd_tf32_width``), lse and delta rows (once for dQ, a stage
    each for dK/dV) and three tiles' int32 segment ids."""
    rows = bwd_rows(D, Dv)
    lse_rows = {"dq": 1, "dkv": TF32_STAGES}[kernel]
    ld = bwd_tf32_width(D, Dv) + TF32_PAD
    floats = (1 + TF32_STAGES) * 2 * rows * ld + lse_rows * 2 * rows
    return 4 * floats + 4 * (1 + TF32_STAGES) * rows


#: blocks of the decode's thread-block cluster: the live keys of a (row, kv
#: head) are split over them (8 is the portable cluster size)
DECODE_CLUSTER = 8
#: threads of a decode block and of a delta block
DECODE_THREADS = DELTA_THREADS = 256
#: the decode's shared K/V ring, its (rep, tk) f32 score tile, and the
#: cluster's partials that rank 0 receives, at most, bytes
DECODE_RING_BYTES, DECODE_SCORE_BYTES = 128 * 1024, 32 * 1024
DECODE_PARTIAL_BYTES = 96 * 1024
#: row passes whose loads a delta thread issues together (``DELTA_U``)
DELTA_PASSES = 4


def _lanes(chunks: int) -> int:
    """Lanes a row of ``chunks`` 16-byte chunks: the largest power of two
    up to min(chunks, 32), so a lane takes at most two chunks (64 at the
    most: f32 at head dim 256)."""
    lanes = 1
    while lanes * 2 <= min(chunks, 32):
        lanes *= 2
    return lanes


class DecodeGeometry(NamedTuple):
    cluster: int    # blocks a (row, kv head)
    tk: int         # keys a ring stage
    stages: int     # ring stages: 1 where one holds a rank's keys, else 2
    lpr: int        # lanes a shared K row
    Dp: int         # head dims padded to whole 16-byte chunks
    Dvp: int
    smem: int       # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=256)
def decode_geometry(L: int, rep: int, D: int, Dv: int, itemsize: int,
                    cluster: int = DECODE_CLUSTER) -> DecodeGeometry:
    """The decode kernel's launch geometry from the shapes alone (never from
    ``lengths``). ``cluster`` shrinks where the ranks' partials (2 rep + rep
    Dv floats each) would pass ``DECODE_PARTIAL_BYTES``; the ring holds one
    stage of ceil(L / cluster) keys where that fits in
    ``DECODE_RING_BYTES`` and the block's shared memory, else two smaller
    stages. ``smem`` is ``decode_smem`` of ``flash_decode_sm90.cu``: the
    ring, the (rep, tk) f32 scores, m, l, corr, a 16-byte chunk of f32 sums
    a thread and the cluster's partials."""
    epc = 16 // itemsize
    Dp, Dvp = -(-D // epc) * epc, -(-Dv // epc) * epc
    row = (Dp + Dvp) * itemsize
    part = 4 * (2 * rep + rep * Dv)
    cluster = max(1, min(cluster, DECODE_PARTIAL_BYTES // part))
    fixed = 4 * (3 * rep + DECODE_THREADS * epc) + cluster * part
    room = SMEM_LIMIT - fixed             # for the ring and the scores
    most = -(-L // cluster)               # keys of the fullest rank
    score_cap = DECODE_SCORE_BYTES // (4 * rep)
    tk = min(most, DECODE_RING_BYTES // row, room // (row + 4 * rep),
             score_cap)
    stages = 1
    if tk < most:
        stages = 2
        tk = max(1, min(DECODE_RING_BYTES // (2 * row),
                        room // (2 * row + 4 * rep), score_cap))
    smem = stages * tk * row + 4 * rep * tk + fixed
    return DecodeGeometry(cluster, tk, stages, _lanes(Dp // epc), Dp, Dvp,
                          smem)


def decode_split(length: int, L: int, cluster: int = DECODE_CLUSTER):
    """-> [(first, end)] keys of each rank for one row, as each block of the
    decode kernel computes them: len = min(max(length, 0), L), c =
    ceil(len / cluster), rank r takes [r c, min((r + 1) c, len))."""
    n = min(max(int(length), 0), L)
    c = -(-n // cluster)
    firsts = [min(r * c, n) for r in range(cluster)]
    return [(first, min(first + c, n)) for first in firsts]


class DeltaGeometry(NamedTuple):
    lpr: int        # lanes a (s, h) row
    nvec: int       # 16-byte chunks of a row's vector body (0: all tail)
    ts: int         # sequence positions a block
    smem: int       # the block's shared memory, bytes


@functools.lru_cache(maxsize=256)
def delta_geometry(H: int, Dv: int, itemsize: int) -> DeltaGeometry:
    """delta's launch geometry: lanes a row, the row's vector body where
    rows are whole 16-byte chunks (else all scalar tail), and the positions
    a block, whose ts * H rows fill the ``DELTA_PASSES`` passes of one load
    batch (1 to 32 positions); shared memory ts * H floats."""
    epc = 16 // itemsize
    nvec = Dv // epc if Dv % epc == 0 else 0
    lpr = _lanes(nvec) if nvec else 32
    rows = DELTA_THREADS // lpr * DELTA_PASSES
    ts = max(1, min(32, rows // H))
    return DeltaGeometry(lpr, nvec, ts, 4 * ts * H)


def decode_block(L: int) -> Optional[int]:
    """The reference's k-block size for a cache of length ``L`` (None: no
    ragged kernel for this geometry). Prefers the largest block that still
    gives the ragged loop >= 4 steps."""
    largest = None
    for bd in DECODE_BLOCKS:
        if L % bd == 0:
            if largest is None:
                largest = bd
            if 4 * bd <= L:
                return bd
    return largest


# ================================================= plain versions =======
def _scores(q, k, segments, causal, window, scale):
    """-> (q * scale as (B, S, K, rep, D) f32, the masked f32 scores
    (B, S, K, rep, S) with the finite NEG_INF at masked pairs)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    qr = q.reshape(B, S, K, H // K, D).float() * scale
    s = torch.einsum("bqkrd,bskd->bqkrs", qr, k.float())
    idx = torch.arange(S, device=q.device)
    d = idx[:, None] - idx[None, :]
    ok = torch.ones((B, S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (d >= 0)[None]
    if window and window > 0:
        ok = ok & (d < window)[None]
    if segments is not None:
        ok = ok & (segments[:, :, None] == segments[:, None, :])
    return qr, torch.where(ok[:, :, None, None, :], s, NEG_INF)


def flash_attention_ref(q, k, v, segments=None, *, causal: bool = True,
                        window: int = 0, scale: Optional[float] = None,
                        with_lse: bool = False):
    """Full-softmax attention -> o (B, S, H, Dv) in q's dtype, and with
    ``with_lse`` the (B, H, S) f32 logsumexp of each row's valid scores."""
    B, S, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    _, s = _scores(q, k, segments, causal, window, scale)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkrs,bskd->bqkrd", p, v.float())
    out = out.reshape(B, S, H, v.shape[-1]).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.logsumexp(s, dim=-1).reshape(B, S, H).permute(0, 2, 1)
    return out, lse.contiguous()


def flash_bwd_delta_ref(o, do):
    """delta (B, H, S) f32 = sum over Dv of dO * O, from o, do
    (B, S, H, Dv)."""
    return (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()


def _bwd_probs(q, k, v, do, lse, delta, segments, causal, window, scale):
    """-> (q * scale, dO, p, ds) as (B, S, K, rep, ...) f32: p rebuilt from
    the LSE (exactly 0 at masked pairs), ds = p * (dO v^T - delta)."""
    B, S, H, _ = q.shape
    K = k.shape[2]
    qr, s = _scores(q, k, segments, causal, window, scale)
    p = torch.exp(s - lse.permute(0, 2, 1).reshape(B, S, K, H // K, 1))
    dof = do.reshape(B, S, K, H // K, v.shape[-1]).float()
    dp = torch.einsum("bqkrd,bskd->bqkrs", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 1).reshape(B, S, K, H // K, 1))
    return qr, dof, p, ds


def flash_bwd_dq_ref(q, k, v, do, lse, delta, segments=None, *,
                     causal: bool = True, window: int = 0,
                     scale: Optional[float] = None):
    """dq (B, S, H, D) in q's dtype = (ds k) * scale."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _, _, _, ds = _bwd_probs(q, k, v, do, lse, delta, segments, causal,
                             window, scale)
    dq = torch.einsum("bqkrs,bskd->bqkrd", ds, k.float()) * scale
    return dq.reshape(q.shape).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, segments=None, *,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None):
    """(dk (B, S, K, D), dv (B, S, K, Dv)) in k's / v's dtype: ds^T (q
    scale) and p^T dO, summed over the H/K q heads of each kv head."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qr, dof, p, ds = _bwd_probs(q, k, v, do, lse, delta, segments, causal,
                                window, scale)
    dk = torch.einsum("bqkrs,bqkrd->bskd", ds, qr)
    dv = torch.einsum("bqkrs,bqkrd->bskd", p, dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, o, lse, do, segments=None, *,
                            causal: bool = True, window: int = 0,
                            scale: Optional[float] = None):
    """(dq, dk, dv) from the saved (q, k, v, o, lse) and dO: the three
    plain backward parts in the order the kernels run."""
    delta = flash_bwd_delta_ref(o, do)
    kw = dict(causal=causal, window=window, scale=scale)
    dq = flash_bwd_dq_ref(q, k, v, do, lse, delta, segments, **kw)
    return (dq,) + flash_bwd_dkv_ref(q, k, v, do, lse, delta, segments, **kw)


def flash_decode_ref(q, k, v, lengths, *, scale: Optional[float] = None):
    """Ragged decode: q (B, 1, H, D) attends slots [0, lengths[b]) of a
    (B, L, K, D) / (B, L, K, Dv) cache -> (B, 1, H, Dv); zeros where
    lengths[b] == 0."""
    B, _, H, D = q.shape
    L, K = k.shape[1], k.shape[2]
    rep = H // K
    if scale is None:
        scale = D ** -0.5
    qr = q.reshape(B, 1, K, rep, D).float() * scale
    s = torch.einsum("bqkrd,bskd->bqkrs", qr, k.float())
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    ok = torch.arange(L, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(ok[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkrs,bskd->bqkrd", p, v.float())
    out = torch.where((lengths > 0).reshape(B, 1, 1, 1, 1), out, 0.0)
    return out.reshape(B, 1, H, v.shape[-1]).to(q.dtype)


def tolerance(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per-element limit on |got - want| between a CUDA kernel and its plain
    version: 1e-5 of the tensor's largest magnitude plus 1e-5 relative
    (the sums run in another order, and the kernels contract a*b+c); in
    bf16 one ulp of the larger of the two on top (the f32 results round to
    neighbours at worst; near zero the f32 sums' cancellation error is many
    ulps of the tiny value, which the first term covers)."""
    g, w = got.float(), want.float()
    lim = 1e-5 * w.abs().max() + 1e-5 * w.abs()
    if got.dtype == torch.bfloat16:
        ax = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
        lim = lim + torch.exp2(torch.floor(torch.log2(ax)) - 7)
    return lim


# ================================================= CUDA kernels =========
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.tri_flash_fwd.argtypes is None:     # first use: declare the ABI
        lib.tri_flash_fwd.argtypes = [_P] * 6 + [_I] * 9 + [_F, _P]
        lib.tri_flash_fwd.restype = _I
    return lib


def _decode_lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode_sm90")
    if lib.tri_flash_decode.argtypes is None:  # first use: declare the ABI
        lib.tri_flash_decode.argtypes = [_P] * 5 + [_I] * 7 + [_F] + [_I] * 4 \
            + [_P]
        lib.tri_flash_decode.restype = _I
        lib.tri_flash_decode_smem.argtypes = [_I] * 10
        lib.tri_flash_decode_smem.restype = ctypes.c_long
    return lib


def _tc_lib() -> ctypes.CDLL:
    lib = _build.load("flash_fwd_sm90")
    if lib.tri_flash_fwd_tc.argtypes is None:  # first use: declare the ABI
        lib.tri_flash_fwd_tc.argtypes = [_P] * 6 + [_I] * 8 + [_F, _P]
        lib.tri_flash_fwd_tc.restype = _I
    return lib


def _tc_bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_bwd_sm90")
    if lib.tri_flash_bwd_dq_tc.argtypes is None:   # first use: the ABI
        lib.tri_flash_bwd_dq_tc.argtypes = [_P] * 8 + [_I] * 8 + [_F, _P]
        lib.tri_flash_bwd_dq_tc.restype = _I
        lib.tri_flash_bwd_dkv_tc.argtypes = [_P] * 9 + [_I] * 8 + [_F, _P]
        lib.tri_flash_bwd_dkv_tc.restype = _I
    return lib


def _tf32_bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_bwd_tf32")
    if lib.tri_flash_bwd_dq_tf32.argtypes is None:     # first use: the ABI
        lib.tri_flash_bwd_dq_tf32.argtypes = [_P] * 8 + [_I] * 9 + [_F, _I,
                                                                    _P]
        lib.tri_flash_bwd_dq_tf32.restype = _I
        lib.tri_flash_bwd_dkv_tf32.argtypes = [_P] * 9 + [_I] * 9 + [_F, _I,
                                                                     _P]
        lib.tri_flash_bwd_dkv_tf32.restype = _I
        lib.tri_flash_bwd_tf32_smem.argtypes = [_I] * 4
        lib.tri_flash_bwd_tf32_smem.restype = ctypes.c_long
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    if lib.tri_flash_bwd_dq.argtypes is None:  # first use: declare the ABI
        lib.tri_flash_bwd_delta.argtypes = [_P] * 3 + [_I] * 7 + [_P]
        lib.tri_flash_bwd_delta.restype = _I
        lib.tri_flash_bwd_dq.argtypes = [_P] * 8 + [_I] * 9 + [_F, _I, _P]
        lib.tri_flash_bwd_dq.restype = _I
        lib.tri_flash_bwd_dkv.argtypes = [_P] * 9 + [_I] * 9 + [_F, _I, _P]
        lib.tri_flash_bwd_dkv.restype = _I
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _dims(q, k, v):
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q: dtype {q.dtype} not in {tuple(_DTYPE_CODE)}")
    B, S, H, D = q.shape
    K, Dv = k.shape[2], v.shape[-1]
    if K < 1 or H % K:
        raise ValueError(f"q heads {H} not a multiple of kv heads {K}")
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"head dims ({D}, {Dv}) above {MAX_HEAD_DIM}")
    return B, S, H, K, D, Dv


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def flash_attention_cuda(q, k, v, segments=None, *, causal: bool = True,
                         window: int = 0, scale: Optional[float] = None,
                         with_lse: bool = False):
    """The forward kernel ``fwd_route`` picks -> o (and the (B, H, S) f32
    LSE with ``with_lse``); outputs are fresh tensors."""
    B, S, H, K, D, Dv = _dims(q, k, v)
    route = fwd_route(q.dtype, D, Dv)
    if S % CUDA_BQ:
        raise ValueError(f"seq len {S} not a multiple of {CUDA_BQ}")
    _check(q, "q", q.dtype, (B, S, H, D))
    _check(k, "k", q.dtype, (B, S, K, D))
    _check(v, "v", q.dtype, (B, S, K, Dv))
    dev = q.device
    seg = None
    if segments is not None:
        seg = segments.to(torch.int32).contiguous()
        _check(seg, "segments", torch.int32, (B, S))
    if k.device != dev or v.device != dev or (seg is not None
                                              and seg.device != dev):
        raise ValueError("flash_attention inputs lie on different devices")
    if scale is None:
        scale = D ** -0.5
    o = torch.empty((B, S, H, Dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if with_lse else None)
    seg_p = seg.data_ptr() if seg is not None else None
    lse_p = lse.data_ptr() if lse is not None else None
    dims = (B, S, H, K, D, Dv, int(bool(causal)), int(window or 0),
            float(scale))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "tc":
            rc = _tc_lib().tri_flash_fwd_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_p,
                o.data_ptr(), lse_p, *dims, stream)
        else:
            rc = _lib().tri_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_p,
                o.data_ptr(), lse_p, _DTYPE_CODE[q.dtype], *dims, stream)
    _raise_on(rc, f"flash_attention ({route})")
    return (o, lse) if with_lse else o


def flash_bwd_delta_cuda(o, do):
    """The delta kernel -> (B, H, S) f32, a fresh tensor."""
    if o.dtype not in _DTYPE_CODE:
        raise ValueError(f"o: dtype {o.dtype} not in {tuple(_DTYPE_CODE)}")
    B, S, H, Dv = o.shape
    if Dv > MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dv} above {MAX_HEAD_DIM}")
    _check(o, "o", o.dtype, (B, S, H, Dv))
    _check(do, "do", o.dtype, (B, S, H, Dv))
    if do.device != o.device:
        raise ValueError("flash_bwd_delta inputs lie on different devices")
    delta = torch.empty((B, H, S), dtype=torch.float32, device=o.device)
    geo = delta_geometry(H, Dv, o.element_size())
    with torch.cuda.device(o.device):
        rc = _bwd_lib().tri_flash_bwd_delta(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(),
            _DTYPE_CODE[o.dtype], B, S, H, Dv, geo.ts, geo.lpr,
            torch.cuda.current_stream(o.device).cuda_stream)
    _raise_on(rc, "flash_bwd_delta")
    return delta


def _bwd_args(q, k, v, do, lse, delta, segments):
    """Check the backward kernels' inputs -> (dims, int32 segments or
    None)."""
    B, S, H, K, D, Dv = _dims(q, k, v)
    if S % CUDA_BQ:
        raise ValueError(f"seq len {S} not a multiple of {CUDA_BQ}")
    _check(q, "q", q.dtype, (B, S, H, D))
    _check(k, "k", q.dtype, (B, S, K, D))
    _check(v, "v", q.dtype, (B, S, K, Dv))
    _check(do, "do", q.dtype, (B, S, H, Dv))
    _check(lse, "lse", torch.float32, (B, H, S))
    _check(delta, "delta", torch.float32, (B, H, S))
    seg = None
    if segments is not None:
        seg = segments.to(torch.int32).contiguous()
        _check(seg, "segments", torch.int32, (B, S))
    if any(t.device != q.device for t in (k, v, do, lse, delta)) or (
            seg is not None and seg.device != q.device):
        raise ValueError("flash backward inputs lie on different devices")
    return (B, S, H, K, D, Dv), seg


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, segments=None, *,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None):
    """The dQ kernel ``bwd_route`` picks -> dq (B, S, H, D) in q's dtype, a
    fresh tensor."""
    (B, S, H, K, D, Dv), seg = _bwd_args(q, k, v, do, lse, delta, segments)
    route = bwd_route(q.dtype, D, Dv)
    if scale is None:
        scale = D ** -0.5
    dq = torch.empty_like(q)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(),
           seg.data_ptr() if seg is not None else None, dq.data_ptr())
    dims = (B, S, H, K, D, Dv, int(bool(causal)), int(window or 0),
            float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "tc":
            rc = _tc_bwd_lib().tri_flash_bwd_dq_tc(*ins, *dims, stream)
        else:
            fn = (_tf32_bwd_lib().tri_flash_bwd_dq_tf32 if route == "tf32"
                  else _bwd_lib().tri_flash_bwd_dq)
            rc = fn(*ins, _DTYPE_CODE[q.dtype], *dims, bwd_rows(D, Dv),
                    stream)
    _raise_on(rc, f"flash_bwd_dq ({route})")
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, segments=None, *,
                       causal: bool = True, window: int = 0,
                       scale: Optional[float] = None):
    """The dK/dV kernel ``bwd_route`` picks -> (dk, dv) in k's / v's dtype,
    fresh tensors."""
    (B, S, H, K, D, Dv), seg = _bwd_args(q, k, v, do, lse, delta, segments)
    route = bwd_route(q.dtype, D, Dv)
    if scale is None:
        scale = D ** -0.5
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(),
           seg.data_ptr() if seg is not None else None, dk.data_ptr(),
           dv.data_ptr())
    dims = (B, S, H, K, D, Dv, int(bool(causal)), int(window or 0),
            float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "tc":
            rc = _tc_bwd_lib().tri_flash_bwd_dkv_tc(*ins, *dims, stream)
        else:
            fn = (_tf32_bwd_lib().tri_flash_bwd_dkv_tf32 if route == "tf32"
                  else _bwd_lib().tri_flash_bwd_dkv)
            rc = fn(*ins, _DTYPE_CODE[q.dtype], *dims, bwd_rows(D, Dv),
                    stream)
    _raise_on(rc, f"flash_bwd_dkv ({route})")
    return dk, dv


def flash_decode_cuda(q, k, v, lengths, *, scale: Optional[float] = None):
    """The ragged decode kernel -> (B, 1, H, Dv), a fresh tensor. Its grid
    and shared memory come from the shapes (``decode_geometry``); the
    lengths are read on the card only."""
    B, one, H, K, D, Dv = _dims(q, k, v)
    L = k.shape[1]
    if one != 1:
        raise ValueError(f"decode takes one query token, got {one}")
    if (H // K) * Dv > 2048:
        raise ValueError(f"(H/K) * Dv = {(H // K) * Dv} above 2048")
    _check(q, "q", q.dtype, (B, 1, H, D))
    _check(k, "k", q.dtype, (B, L, K, D))
    _check(v, "v", q.dtype, (B, L, K, Dv))
    lens = lengths.to(torch.int32).contiguous()
    _check(lens, "lengths", torch.int32, (B,))
    dev = q.device
    if k.device != dev or v.device != dev or lens.device != dev:
        raise ValueError("flash_decode inputs lie on different devices")
    if scale is None:
        scale = D ** -0.5
    o = torch.empty((B, 1, H, Dv), dtype=q.dtype, device=dev)
    geo = decode_geometry(L, H // K, D, Dv, q.element_size())
    with torch.cuda.device(dev):
        rc = _decode_lib().tri_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            o.data_ptr(), _DTYPE_CODE[q.dtype], B, L, H, K, D, Dv,
            float(scale), geo.cluster, geo.tk, geo.stages, geo.lpr,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "flash_decode")
    return o
