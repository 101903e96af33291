"""The typed SpGEMM failure taxonomy (port of ``repro/runtime/validate.py``).

Same class names and the same base classes as the reference, so callers
catch the port's errors exactly as they catch the JAX package's. Operand
validation (``check_csr``), ``PlanGuard`` and ``resolve_mode`` belong to the
``runtime/`` slice of the port and are not here yet: every entry point of
this slice accepts only ``validate="off"``.
"""
from __future__ import annotations


class SpgemmError(Exception):
    """Base of the typed SpGEMM failure taxonomy."""


class SpgemmInputError(SpgemmError, ValueError):
    """A CSR operand violates its structural or numeric invariants."""


class CapacityOverflowError(SpgemmError, ValueError):
    """A static bucketed capacity (nnz_cap / fm_cap) was exceeded."""


class PlanMismatchError(SpgemmError, ValueError):
    """A pinned plan was replayed against incompatible operands."""


class KernelFallbackError(SpgemmError, RuntimeError):
    """A replay kernel failed. The port has no degradation ladder yet, so
    this is always the give-up; ``__cause__`` carries the original error."""


class SpgemmConfigError(SpgemmError, ValueError):
    """A caller passed an invalid knob, mode, name, or option combination,
    or asked for an option that a later slice of the port brings."""
