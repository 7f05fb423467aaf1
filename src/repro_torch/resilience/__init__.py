"""Trainer-side resilience: deterministic fault injection and recovery
supervision (the reference's ``repro.resilience``, without the soak)."""
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
