"""repro_torch.runtime — host-side robustness layer for the execution stack.

validate: typed error taxonomy + opt-in CSR/plan validation modes.
faults:   deterministic fault injection (data faults + kernel failpoints).
retry:    bounded jittered backoff with typed give-up.
watchdog: liveness heartbeat + per-step/per-replay straggler deadlines.

Port of ``repro/runtime``: the same names, the same error classes.
"""
from repro_torch.runtime.faults import (FAULTS, FaultSpec, InjectedFault, failpoint,
                                        inject_csr, reset_failpoints)
from repro_torch.runtime.retry import RetryExhaustedError, backoff_schedule, retry_call
from repro_torch.runtime.validate import (VALIDATE_MODES, AdmissionRejected,
                                          CapacityOverflowError, DeadlineExceeded,
                                          KernelFallbackError, PlanGuard,
                                          PlanMismatchError, SpgemmConfigError,
                                          SpgemmError, SpgemmInputError,
                                          TrainingDivergedError, check_csr,
                                          resolve_mode)
from repro_torch.runtime.watchdog import Heartbeat, StepWatchdog, StragglerDetected

__all__ = [
    "StepWatchdog",
    "Heartbeat",
    "StragglerDetected",
    "SpgemmError",
    "SpgemmInputError",
    "SpgemmConfigError",
    "TrainingDivergedError",
    "PlanMismatchError",
    "CapacityOverflowError",
    "KernelFallbackError",
    "AdmissionRejected",
    "DeadlineExceeded",
    "RetryExhaustedError",
    "InjectedFault",
    "FaultSpec",
    "FAULTS",
    "PlanGuard",
    "VALIDATE_MODES",
    "check_csr",
    "resolve_mode",
    "failpoint",
    "inject_csr",
    "reset_failpoints",
    "retry_call",
    "backoff_schedule",
]
