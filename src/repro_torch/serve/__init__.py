"""Task-level serving: elastic continuous batching over a task's serving
hooks, with (rung, precision-tier) paths warmed up front and
precision-adaptive decode weights (``repro/serve``)."""
from repro_torch.serve.batching import Request, RequestQueue, pick_rung
from repro_torch.serve.engine import (ServeEngine, repack_caches,
                                      scatter_prefill, tier_params)
from repro_torch.serve.scheduler import LatencyTable
from repro_torch.serve.session import ServeConfig, ServeSession

__all__ = ["Request", "RequestQueue", "pick_rung", "ServeEngine",
           "ServeConfig", "ServeSession", "repack_caches", "scatter_prefill",
           "tier_params", "LatencyTable"]
