"""Tri-Accel §3.3 — Memory-Elastic Batch Scaling on the GPU.

  * ``MemoryModel`` — an analytic per-device memory estimate (params +
    optimizer + gradient + activation(tokens, precision codes)), plus a
    rung-indexed MEASURED overlay. On the card the measurement is the
    paper's own VRAM feedback: ``torch.cuda.max_memory_allocated()`` read
    after ``reset_peak_memory_stats()`` around a rung's first step
    (``measured_peak_bytes``). A rung that has been observed answers with
    its real footprint, an unobserved rung with the analytic model re-fit
    (``calibration``) to the latest measurement.
  * ``BatchScaler`` — the paper's hysteresis law over a discrete ladder of
    per-device microbatch sizes:
        B += delta_up    if mem < rho_low  * cap
        B -= delta_down  if mem > rho_high * cap
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.precision import TriAccelConfig

# bytes per element of each precision tier (low tier: fp8=1 on tpu, fp16=2)
TIER_BYTES = {"gpu": (2.0, 2.0, 4.0), "tpu": (1.0, 2.0, 4.0)}


def measured_peak_bytes(fn: Callable[[], Any],
                        device) -> Tuple[Any, Optional[float]]:
    """Run ``fn()`` and return (its result, the peak bytes the caching
    allocator held while it ran). On the CPU the second item is ``None`` —
    the analytic model answers instead."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return fn(), None
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return out, float(torch.cuda.max_memory_allocated(dev))


@dataclasses.dataclass
class MemoryModel:
    """Per-device memory footprint model (bytes)."""

    param_count: float
    opt_slots: int = 2
    act_bytes_per_token_layer: float = 0.0
    num_layers: int = 1
    fixed_overhead: float = 256e6
    calibration: float = 1.0
    #: rung -> measured bytes (last measurement per rung wins)
    measured: Dict[Any, float] = dataclasses.field(default_factory=dict)
    #: rungs an out-of-memory error condemned (``BatchScaler.mark_oom``);
    #: their overlay entries stay pinned above the cap
    poisoned: set = dataclasses.field(default_factory=set)

    @classmethod
    def for_transformer(cls, param_count, d_model, num_layers, opt_slots=2,
                        remat=True):
        # with block remat only block boundaries are resident:
        # ~2.5 activations of width d_model per layer per token (bf16 = 2B)
        act = (2.5 if remat else 14.0) * d_model * 2.0
        return cls(param_count=param_count, opt_slots=opt_slots,
                   act_bytes_per_token_layer=act, num_layers=num_layers)

    def param_state_bytes(self) -> float:
        # bf16 compute copy + fp32 master + opt slots fp32 + bf16 grads
        return self.param_count * (2.0 + 4.0 + 4.0 * self.opt_slots + 2.0)

    def activation_bytes(self, tokens_per_device: float,
                         codes=None, ladder: str = "gpu") -> float:
        scale = 1.0
        if codes is not None and len(codes) > 0:
            tiers = TIER_BYTES[ladder]
            mean_bytes = sum(tiers[int(c)] for c in codes) / len(codes)
            scale = mean_bytes / 2.0   # relative to bf16 baseline
        return (self.act_bytes_per_token_layer * self.num_layers *
                tokens_per_device * scale)

    def total(self, tokens_per_device: float, codes=None,
              ladder: str = "gpu") -> float:
        return self.calibration * (
            self.param_state_bytes()
            + self.activation_bytes(tokens_per_device, codes, ladder)
            + self.fixed_overhead)

    def calibrate(self, measured_bytes: float, tokens_per_device: float,
                  codes=None, ladder: str = "gpu") -> None:
        if measured_bytes <= 0:
            return
        est = self.total(tokens_per_device, codes, ladder) / self.calibration
        # a subnormal measurement underflows the ratio to 0, which would
        # zero the calibration and divide by it on the next re-fit
        scale = measured_bytes / est if est > 0 else 0.0
        if scale > 0:
            self.calibration = scale

    def measured_key(self, rung: int):
        return rung

    def record_measured(self, rung: int, measured_bytes: float,
                        tokens_per_device: float, codes=None,
                        ladder: str = "gpu") -> None:
        """Store the observed footprint for ``rung`` and re-fit the
        calibration; non-positive observations and poisoned rungs are
        ignored."""
        if measured_bytes <= 0 or self.measured_key(rung) in self.poisoned:
            return
        self.measured[self.measured_key(rung)] = float(measured_bytes)
        self.calibrate(measured_bytes, tokens_per_device, codes, ladder)

    def predict(self, rung: int, tokens_per_device: float, codes=None,
                ladder: str = "gpu") -> float:
        """Measured-first footprint for ``rung``."""
        m = self.measured.get(self.measured_key(rung))
        return m if m is not None else self.total(tokens_per_device, codes,
                                                  ladder)


@dataclasses.dataclass
class ServeMemoryModel(MemoryModel):
    """Inference-time memory model: weights at the ACTIVE serving precision
    tier (``TIER_BYTES``) plus the per-sequence decode-cache bytes carried
    in ``act_bytes_per_token_layer``; no optimizer, master or gradient
    state. Its measured overlay is keyed (rung, tier), as the serving
    engine's measured paths are."""

    weight_tier: int = 1               # serving precision code: 0/1/2
    ladder: str = "tpu"

    def param_state_bytes(self) -> float:
        return self.param_count * TIER_BYTES[self.ladder][self.weight_tier]

    def measured_key(self, rung: int):
        return (rung, self.weight_tier)


class BatchScaler:
    """Discrete-rung realization of the paper's VRAM feedback controller."""

    def __init__(self, rungs: Sequence[int], seq_len: int, model: MemoryModel,
                 cfg: TriAccelConfig, start_rung: Optional[int] = None):
        if list(rungs) != sorted(set(rungs)) or not rungs:
            raise ValueError(f"rungs must be sorted and unique: {rungs}")
        self.rungs = list(rungs)
        self.seq_len = seq_len
        self.model = model
        self.cfg = cfg
        self.idx = (len(rungs) - 1 if start_rung is None
                    else self.rungs.index(start_rung))
        while self.idx > 0 and \
                self._mem(self.idx) > cfg.rho_high * cfg.mem_cap_bytes:
            self.idx -= 1
        self.history: List[Tuple[int, int, float]] = []  # (step, rung, mem)

    @property
    def microbatch(self) -> int:
        return self.rungs[self.idx]

    def _mem(self, idx: int, codes=None) -> float:
        return self.model.predict(self.rungs[idx],
                                  self.rungs[idx] * self.seq_len, codes,
                                  self.cfg.ladder)

    def _cap_index(self, rung_cap: Optional[int]) -> Optional[int]:
        """Index of the largest rung <= ``rung_cap`` (0 when the cap is
        below every rung: the ceiling throttles, it never empties the
        ladder)."""
        if rung_cap is None:
            return None
        idx = 0
        for i, r in enumerate(self.rungs):
            if r <= rung_cap:
                idx = i
        return idx

    def mark_oom(self, rung: Optional[int] = None) -> int:
        """React to an out-of-memory error on ``rung``: poison it at 2x the
        cap and step ``delta_down`` rungs below it. Returns the new
        microbatch (unchanged when the rung is already the smallest)."""
        rung = self.microbatch if rung is None else rung
        key = self.model.measured_key(rung)
        self.model.poisoned.add(key)
        self.model.measured[key] = 2.0 * self.cfg.mem_cap_bytes
        if rung in self.rungs:
            i = self.rungs.index(rung)
            if self.idx >= i:
                self.idx = max(i - self.cfg.delta_down, 0)
        return self.microbatch

    def observe(self, step: int, codes=None,
                measured_bytes: Optional[float] = None,
                rung_cap: Optional[int] = None) -> int:
        """Apply the paper's hysteresis law; returns the (possibly new)
        rung. ``measured_bytes`` (the current rung's measured peak) is
        recorded into the overlay and re-fits the calibration first.
        ``rung_cap`` (the serving latency ceiling) bounds the climb, and a
        rung above it steps down."""
        if not self.cfg.enable_batch:
            return self.microbatch
        if measured_bytes is not None:
            self.model.record_measured(self.rungs[self.idx], measured_bytes,
                                       self.rungs[self.idx] * self.seq_len,
                                       codes, self.cfg.ladder)
            mem = float(measured_bytes)
        else:
            mem = self._mem(self.idx, codes)
        cap = self.cfg.mem_cap_bytes
        cap_i = self._cap_index(rung_cap)
        if mem < self.cfg.rho_low * cap and self.idx + 1 < len(self.rungs):
            nxt = min(self.idx + self.cfg.delta_up, len(self.rungs) - 1)
            if cap_i is not None:
                nxt = min(nxt, cap_i)
            if nxt > self.idx and \
                    self._mem(nxt, codes) <= self.cfg.rho_high * cap:
                self.idx = nxt
        elif mem > self.cfg.rho_high * cap and self.idx > 0:
            self.idx = max(self.idx - self.cfg.delta_down, 0)
        if cap_i is not None and self.idx > cap_i:
            self.idx = max(self.idx - self.cfg.delta_down, cap_i)
        self.history.append((step, self.microbatch, mem))
        return self.microbatch
