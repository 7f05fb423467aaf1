"""The task seam between *what* trains and the Tri-Accel engine that trains
it. Only ``VisionTask`` (the paper's ResNet-18 testbed) is ported so far:

    init(gen)        -> (params, aux_state)   BN running stats ride in aux
    loss(params, aux_state, batch, codes, qdq_fn)
                     -> (loss, new_aux_state, metrics)
    grouping(params) -> LayerGrouping
    data_stream(global_batch, seed) / eval_stream(global_batch, seed)
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.grouping import flat_grouping
from repro_torch.data.synthetic import CIFARLikeStream
from repro_torch.models.vision import VisionConfig, vision_apply, vision_init


@dataclasses.dataclass
class VisionTask:
    """The paper's testbed on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``)."""
    cfg: VisionConfig
    device: Any = "cuda"

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
        if codes is not None or qdq_fn is not None:
            raise NotImplementedError(
                "in-loss QDQ precision emulation belongs to reference_step, "
                "which is not ported yet (ROADMAP A6); the fused path casts "
                "in the apply kernel")
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
