"""Task-level serving: elastic continuous batching over a task's serving
hooks, with (rung, precision-tier) paths warmed up front,
precision-adaptive decode weights, SLO-aware admission, chunked prefill,
trace replay, and cache-free batched inference (``repro/serve``)."""
from repro_torch.serve.batching import Request, RequestQueue, pick_rung
from repro_torch.serve.engine import (ServeEngine, repack_caches,
                                      scatter_prefill, tier_params)
from repro_torch.serve.scheduler import (LatencyTable, Scheduler,
                                         SchedulerConfig)
from repro_torch.serve.session import ServeConfig, ServeSession
from repro_torch.serve.traffic import (Arrival, TrafficClass, class_report,
                                       drive, poisson_trace)

__all__ = ["Request", "RequestQueue", "pick_rung", "ServeEngine",
           "ServeConfig", "ServeSession", "repack_caches", "scatter_prefill",
           "tier_params", "Scheduler", "SchedulerConfig", "LatencyTable",
           "TrafficClass", "Arrival", "poisson_trace", "class_report",
           "drive"]
