"""Chaos-hardened elasticity: deterministic fault injection and recovery
supervision over the trainer and the serving session (the reference's
``repro.resilience``); the chaos soak is ``repro_torch.resilience.soak``."""
from repro_torch.resilience.faults import (CORRUPTION_KINDS, FAULT_SITES,
                                           Fault, FaultPlan,
                                           corrupt_checkpoint, is_oom_error,
                                           simulated_oom)
from repro_torch.resilience.recovery import (DivergenceError,
                                             DivergenceWatchdog,
                                             RecoveryConfig)

__all__ = ["CORRUPTION_KINDS", "FAULT_SITES", "Fault", "FaultPlan",
           "corrupt_checkpoint", "is_oom_error", "simulated_oom",
           "DivergenceError", "DivergenceWatchdog", "RecoveryConfig"]
