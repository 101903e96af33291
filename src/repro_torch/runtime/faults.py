"""Deterministic fault injection for the SpGEMM execution stack.

Two mechanisms, both driven by the chaos suites (``tests/test_torch_runtime.py``
for the port):

**Data faults** — a registry of named, seeded corruptions applied to a CSR
operand (``inject_csr``): scrambled ``indptr``, out-of-bounds or negative
column indices, NaN-poisoned values, a bucketed-capacity overflow, and a
length mismatch. Each ``FaultSpec`` records the typed error class the
validation layer must raise for it, so the chaos suite is table-driven:
every registered fault either raises its typed error (validation on) or the
stack degrades to a bitwise-correct XLA-reference result (validation off) —
never silent wrong values.

**Failpoints** — named sites inside kernel dispatch (``kernel:pallas``,
``kernel:flat_lp``, ...) that raise ``InjectedFault`` when armed, to
exercise the degradation ladder without depending on a real lowering
failure. ``InjectedFault`` deliberately subclasses plain ``RuntimeError``,
*not* the typed taxonomy: the ladder must treat it like any unexpected
kernel explosion. Arm with the ``failpoint(site)`` context manager (or
``arm``/``disarm``); ``reset_failpoints()`` is called by the test autouse
fixture so an armed site can never leak across tests.

Everything here is deterministic: corruptions derive from
``np.random.default_rng(seed)`` and failpoints are explicit host-side
state — a chaos run replays identically every time.

Port of ``repro/runtime/faults.py``: the same registry, sites and seeds.
A corruption is built with numpy on the host, as in the reference, and the
corrupted arrays are moved to the operand's device, so the port and the
reference corrupt the same slot for the same seed.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np

# --------------------------------------------------------------------------
# Failpoints
# --------------------------------------------------------------------------


class InjectedFault(RuntimeError):
    """Raised at an armed failpoint. Intentionally OUTSIDE the typed
    SpgemmError taxonomy: dispatch sites must handle it as an unexpected
    kernel failure (degradation ladder), not as a validated input error."""


_FAILPOINTS: set[str] = set()


def arm(site: str) -> None:
    """Arm ``site``: the next ``check(site)`` there raises InjectedFault."""
    _FAILPOINTS.add(site)


def disarm(site: str) -> None:
    _FAILPOINTS.discard(site)


def armed(site: str) -> bool:
    return site in _FAILPOINTS


def check(site: str) -> None:
    """Called by instrumented dispatch sites; raises when the site is armed.

    A no-op set lookup when nothing is armed — cheap enough to live on the
    hot path unconditionally.
    """
    if site in _FAILPOINTS:
        raise InjectedFault(f"injected fault at failpoint {site!r}")


def reset_failpoints() -> None:
    """Disarm every failpoint (test-fixture hygiene)."""
    _FAILPOINTS.clear()


@contextlib.contextmanager
def failpoint(site: str):
    """Arm ``site`` for the duration of the with-block, then disarm."""
    arm(site)
    try:
        yield
    finally:
        disarm(site)


# --------------------------------------------------------------------------
# Data-fault registry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One registered corruption.

    name:        registry key (and chaos-test parametrize id).
    kind:        "data" (corrupts a CSR) | "kernel" (failpoint site) |
                 "cache" (plan-cache manipulation).
    expects:     the typed error class validation must raise for it, or
                 None when the fault is not a validation concern (kernel/
                 cache faults surface through the ladder / re-resolution).
    description: one line for humans and test output.
    fn:          data faults: (csr, rng) -> corrupted csr.
    site:        kernel faults: the failpoint site string.
    """

    name: str
    kind: str
    expects: type | None
    description: str
    fn: Callable | None = None
    site: str | None = None


def _rebuild(csr, indptr=None, indices=None, values=None):
    """A copy of ``csr`` with selected arrays replaced, skipping
    ``from_arrays`` validation (we are deliberately building bad CSRs)."""
    from repro_torch.sparse.formats import CSR

    return CSR.from_arrays(
        csr.indptr if indptr is None else indptr,
        csr.indices if indices is None else indices,
        csr.values if values is None else values,
        csr.shape,
        validate=False,
        device=csr.device,
    )


def _np(t) -> np.ndarray:
    """A host copy of one of the operand's tensors, to corrupt with numpy."""
    return t.detach().cpu().numpy().copy()


def _corrupt_indptr(csr, rng):
    ip = _np(csr.indptr)
    # break monotonicity at a random interior row
    i = int(rng.integers(1, max(len(ip) - 1, 2)))
    ip[i] = ip[min(i + 1, len(ip) - 1)] + 7
    return _rebuild(csr, indptr=ip)


def _oob_col_index(csr, rng):
    idx = _np(csr.indices)
    nnz = int(csr.indptr[-1])
    slot = int(rng.integers(0, max(nnz, 1)))
    idx[slot] = csr.k + 3  # past the column bound
    return _rebuild(csr, indices=idx)


def _negative_col_index(csr, rng):
    idx = _np(csr.indices)
    nnz = int(csr.indptr[-1])
    idx[int(rng.integers(0, max(nnz, 1)))] = -1
    return _rebuild(csr, indices=idx)


def _nan_values(csr, rng):
    # on a clone of the tensor: numpy has no bfloat16
    vals = csr.values.clone()
    nnz = int(csr.indptr[-1])
    vals[int(rng.integers(0, max(nnz, 1)))] = float("nan")
    return _rebuild(csr, values=vals)


def _capacity_overflow(csr, rng):
    # keep indptr monotone but claim more live entries than the buffer holds
    ip = _np(csr.indptr)
    ip[-1] = csr.nnz_cap + 8
    return _rebuild(csr, indptr=ip)


def _length_mismatch(csr, rng):
    # drop the last value slot so len(indices) != len(values)
    return _rebuild(csr, values=csr.values[:-1].clone())


def _build_registry() -> dict[str, FaultSpec]:
    from repro_torch.runtime.validate import CapacityOverflowError, SpgemmInputError

    specs = [
        FaultSpec("corrupt_indptr", "data", SpgemmInputError,
                  "non-monotone indptr at a random interior row",
                  fn=_corrupt_indptr),
        FaultSpec("oob_col_index", "data", SpgemmInputError,
                  "live column index >= k", fn=_oob_col_index),
        FaultSpec("negative_col_index", "data", SpgemmInputError,
                  "live column index == -1", fn=_negative_col_index),
        FaultSpec("nan_values", "data", SpgemmInputError,
                  "NaN planted in a live value slot", fn=_nan_values),
        FaultSpec("capacity_overflow", "data", CapacityOverflowError,
                  "indptr[-1] pushed past nnz_cap (monotone otherwise)",
                  fn=_capacity_overflow),
        FaultSpec("length_mismatch", "data", SpgemmInputError,
                  "values buffer one slot shorter than indices",
                  fn=_length_mismatch),
        FaultSpec("kernel_pallas", "kernel", None,
                  "segsum_reuse Pallas replay raises mid-dispatch",
                  site="kernel:pallas"),
        FaultSpec("kernel_pallas_lp", "kernel", None,
                  "LP-hash Pallas replay raises mid-dispatch",
                  site="kernel:pallas_lp"),
        FaultSpec("kernel_flat_lp", "kernel", None,
                  "flat_lp numeric kernel raises", site="kernel:flat_lp"),
        FaultSpec("kernel_dense_acc", "kernel", None,
                  "dense_acc numeric kernel raises",
                  site="kernel:dense_acc"),
        FaultSpec("plan_cache_eviction", "cache", None,
                  "plan cache cleared mid-replay (simulated eviction)"),
    ]
    return {s.name: s for s in specs}


FAULTS: dict[str, FaultSpec] = _build_registry()


def data_faults() -> list[FaultSpec]:
    return [s for s in FAULTS.values() if s.kind == "data"]


def kernel_faults() -> list[FaultSpec]:
    return [s for s in FAULTS.values() if s.kind == "kernel"]


def inject_csr(name: str, csr, seed: int = 0):
    """Apply registered data fault ``name`` to ``csr`` deterministically."""
    spec = FAULTS[name]
    if spec.kind != "data":
        from repro_torch.runtime.validate import SpgemmConfigError  # cycle-free
        raise SpgemmConfigError(
            f"fault {name!r} is kind={spec.kind!r}, not a data "
            "fault — arm its failpoint instead")
    return spec.fn(csr, np.random.default_rng(seed))
