"""The task seam between *what* runs and the Tri-Accel engine that runs it.
``VisionTask`` (the paper's ResNet-18 testbed) carries the training hooks:

    init(gen)        -> (params, aux_state)   BN running stats ride in aux
    loss(params, aux_state, batch, codes, qdq_fn)
                     -> (loss, new_aux_state, metrics)
    grouping(params) -> LayerGrouping
    data_stream(global_batch, seed) / eval_stream(global_batch, seed)

``LMTask`` carries the same training hooks (``loss_codes`` keeps the
first ``num_layers`` codes: the grouping's embed/head pseudo-layers never
reach the stack) and the serving hooks that ``repro_torch.serve`` drives:

    init_cache(batch, total_len)          empty decode caches for B slots
    prefill(params, batch)                -> (last-position logits, caches)
    decode(params, caches, token, index)  -> (logits, caches), in place
    serve_input_spec(prompt_len)          one request's input shapes
    serve_memory_model(params, total_len) weights + decode-cache bytes
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch import tree as tu
from repro_torch.core.grouping import flat_grouping, lm_grouping
from repro_torch.data.synthetic import CIFARLikeStream, LMTaskStream
from repro_torch.kernels import ops
from repro_torch.models.lm import (LMConfig, lm_decode_step, lm_init,
                                   lm_init_cache, lm_loss, lm_prefill)
from repro_torch.models.vision import VisionConfig, vision_apply, vision_init


class TensorSpec(NamedTuple):
    """Shape and dtype of one input (the port's ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _serve_batch_size(batch) -> int:
    """Leading dim of any batch leaf (tensors or ``TensorSpec``s)."""
    return int(next(iter(batch.values())).shape[0])


def apply_codes(params, codes, qdq_fn, keys):
    """Per-top-level-block QDQ actuation (the vision counterpart of the LM
    stack's per-layer codes): block ``keys[i]`` rounds at ``codes[i]``."""
    if qdq_fn is None:
        return params
    return {k: tu.tree_map(lambda w, c=codes[i]: qdq_fn(w, c), params[k])
            for i, k in enumerate(keys)}


@dataclasses.dataclass
class VisionTask:
    """The paper's testbed on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``)."""
    cfg: VisionConfig
    device: Any = "cuda"
    #: cache-free batched inference (``infer``), not yet ported
    serves_tokens = False

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def name(self) -> str:
        return self.cfg.name

    @property
    def compute_dtype(self):
        return self.cfg.compute_dtype

    def init(self, gen: torch.Generator, device=None):
        """-> (params, aux_state); ``device`` overrides the task's (e.g.
        ``"meta"`` for shapes only)."""
        return vision_init(gen, self.cfg,
                           self.device if device is None else device)

    def loss(self, params, aux_state, batch, codes, qdq_fn):
        if codes is not None:
            params = apply_codes(params, codes, qdq_fn, sorted(params))
        logits, new_aux = vision_apply(params, aux_state, batch["images"],
                                       True, self.cfg)
        labels = batch["labels"].long()
        one = F.one_hot(labels, self.cfg.num_classes).float()
        loss = -(one * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()
        acc = (logits.argmax(dim=-1) == labels).float().mean()
        return loss, new_aux, {"loss": loss.detach(), "accuracy": acc}

    def grouping(self, params):
        return flat_grouping(params)

    def tokens_per_sample(self, seq_len: int) -> int:
        return 1

    def loss_codes(self, codes: torch.Tensor) -> torch.Tensor:
        return codes

    def data_stream(self, global_batch, seed=0, seq_len: int = 1):
        return CIFARLikeStream(num_classes=self.cfg.num_classes,
                               global_batch=global_batch, seed=seed,
                               device=self.device)

    def eval_stream(self, global_batch, seed=0):
        return CIFARLikeStream(num_classes=self.cfg.num_classes,
                               global_batch=global_batch, seed=seed,
                               train=False, device=self.device)

    @torch.no_grad()
    def evaluate(self, params, aux_state, batch) -> torch.Tensor:
        """Held-out top-1 accuracy (BN in inference mode)."""
        logits, _ = vision_apply(params, aux_state, batch["images"], False,
                                 self.cfg)
        return (logits.argmax(dim=-1) == batch["labels"].long()
                ).float().mean()

    def memory_model(self, params, opt_slots: int, mesh_size: int = 1):
        # calibrated against the paper's published FP32 point
        from repro_torch.train.paper_harness import vision_memory_model
        return vision_memory_model(self.cfg, params)

    def curvature_loss(self, params, aux_state, batch) -> torch.Tensor:
        """Scalar loss for the §3.2 curvature probes (no loss scale)."""
        return self.loss(params, aux_state, batch, None, None)[0]


@dataclasses.dataclass
class LMTask:
    """A decoder-only LM on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``): training and serving hooks."""
    cfg: LMConfig
    device: Any = "cuda"
    serves_tokens = True

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def name(self) -> str:
        return self.cfg.name

    @property
    def compute_dtype(self):
        return self.cfg.compute_dtype

    def init(self, gen: torch.Generator, device=None):
        """-> (params, aux_state={}); ``device`` overrides the task's."""
        return lm_init(gen, self.cfg,
                       self.device if device is None else device), {}

    def tokens_per_sample(self, seq_len: int) -> int:
        return seq_len

    def loss(self, params, aux_state, batch, codes, qdq_fn):
        total, metrics = lm_loss(params, batch, self.cfg,
                                 codes=codes if qdq_fn is not None else None,
                                 qdq_fn=qdq_fn)
        return total, aux_state, {k: v.detach() for k, v in metrics.items()}

    def grouping(self, params):
        return lm_grouping(params, self.cfg.stack)

    def loss_codes(self, codes: torch.Tensor) -> torch.Tensor:
        return codes[: self.cfg.stack.num_layers]

    def data_stream(self, global_batch, seed=0, seq_len: int = 128):
        return LMTaskStream(self.cfg.vocab_size, seq_len, global_batch,
                            seed=seed, device=self.device)

    def eval_stream(self, global_batch, seed=0):
        return self.data_stream(global_batch, seed)

    def memory_model(self, params, opt_slots: int, mesh_size: int = 1):
        from repro_torch.core.batch_scaler import MemoryModel
        n = sum(int(x.numel()) for x in tu.leaves(params))
        return MemoryModel.for_transformer(
            n / mesh_size, self.cfg.d_model, self.cfg.num_layers,
            opt_slots=opt_slots, remat=self.cfg.stack.remat)

    def curvature_loss(self, params, aux_state, batch) -> torch.Tensor:
        """Scalar loss for the §3.2 curvature probes (no loss scale), on
        the chunked attention path as the reference pins it
        (``flash_fallback``: its forward-mode probes cannot cross the
        kernel's custom_vjp). The probe batches are b_curv-sized, so the
        fallback costs little, and the probe launches no attention
        kernel."""
        with ops.flash_fallback():
            return self.loss(params, aux_state, batch, None, None)[0]

    # --------------------------------------------------------- serving ----
    def init_cache(self, batch, total_len: int, dtype=torch.bfloat16,
                   device=None):
        """Empty decode caches for ``batch``'s leading dim of slots over
        positions [0, total_len)."""
        return lm_init_cache(self.cfg, _serve_batch_size(batch), total_len,
                             dtype, self.device if device is None else device)

    def prefill(self, params, batch):
        return lm_prefill(params, batch, self.cfg)

    def decode(self, params, caches, token, index):
        return lm_decode_step(params, token, caches, index, self.cfg)

    def serve_input_spec(self, prompt_len: int):
        return {"tokens": TensorSpec((1, prompt_len), torch.int32)}

    def serve_memory_model(self, params, total_len: int, mesh_size: int = 1,
                           ladder: str = "tpu", weight_tier: int = 1,
                           spec_len: int = 1, **kw):
        """Weights at the active tier + decode-cache bytes per slot."""
        from repro_torch.core.batch_scaler import ServeMemoryModel
        n = sum(int(x.numel()) for x in tu.leaves(params))
        cache = self.init_cache(self.serve_input_spec(spec_len), total_len,
                                device="meta")
        per_seq = float(sum(x.numel() * x.element_size()
                            for x in tu.leaves(cache)))
        return ServeMemoryModel(
            param_count=n / mesh_size, opt_slots=0,
            act_bytes_per_token_layer=per_seq / max(total_len, 1),
            num_layers=1, fixed_overhead=128e6, ladder=ladder,
            weight_tier=weight_tier)


def task_for_config(cfg, device="cuda"):
    """Model config -> its task on ``device``."""
    if isinstance(cfg, VisionConfig):
        return VisionTask(cfg, device)
    if isinstance(cfg, LMConfig):
        return LMTask(cfg, device)
    raise TypeError(f"no task for config type {type(cfg).__name__}")
