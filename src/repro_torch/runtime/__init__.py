"""Runtime layer of the port: so far only the typed error taxonomy."""
from repro_torch.runtime.validate import (
    CapacityOverflowError,
    KernelFallbackError,
    PlanMismatchError,
    SpgemmConfigError,
    SpgemmError,
    SpgemmInputError,
)

__all__ = [
    "SpgemmError",
    "SpgemmInputError",
    "CapacityOverflowError",
    "PlanMismatchError",
    "KernelFallbackError",
    "SpgemmConfigError",
]
