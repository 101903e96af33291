"""Typed validation layer (port of ``repro/runtime/validate.py``).

The same taxonomy as the reference, class for class and base for base, so
callers catch the port's errors exactly as they catch the JAX package's:

  ``SpgemmInputError``      — a CSR operand violates its invariants
                              (non-monotone ``indptr``, out-of-bounds column
                              indices, non-finite values, mismatched array
                              lengths, negative shape).
  ``CapacityOverflowError`` — a static bucketed capacity is exceeded.
  ``PlanMismatchError``     — a pinned plan replayed against incompatible
                              operands.
  ``KernelFallbackError``   — a kernel failed and the degradation ladder was
                              told to raise or ran out of rungs; in the port
                              also a kernel library that cannot be built or
                              loaded (``kernels._build``), which the ladder
                              lets through and never treats as a rung.
  ``SpgemmConfigError``     — an invalid knob, mode, name or combination.
  ``AdmissionRejected``, ``DeadlineExceeded``, ``TrainingDivergedError`` —
                              the serving and training verdicts.

Validation modes (``spgemm(validate=...)``, ``ReuseExecutor``):

  "off"    — the default: no added work (no launch, no sync, no hash).
  "host"   — copy the operand structure to the host and check every
             invariant, with exact indices in the error message.
  "device" — compute the violation flag word (``_BIT_*``) with torch ops on
             the operands' device and read it with one host read.

``validate=None`` resolves through ``$REPRO_VALIDATE``, else "off".
"""
from __future__ import annotations

import os

import numpy as np
import torch

VALIDATE_MODES = ("off", "host", "device")

# Environment override consulted when a caller passes validate=None.
VALIDATE_ENV_VAR = "REPRO_VALIDATE"


class SpgemmError(Exception):
    """Base of the typed SpGEMM failure taxonomy."""


class SpgemmInputError(SpgemmError, ValueError):
    """A CSR operand violates its structural or numeric invariants."""


class CapacityOverflowError(SpgemmError, ValueError):
    """A static bucketed capacity (nnz_cap / fm_cap) was exceeded."""


class PlanMismatchError(SpgemmError, ValueError):
    """A pinned plan was replayed against incompatible operands."""


class KernelFallbackError(SpgemmError, RuntimeError):
    """A kernel failed and the degradation ladder gave up (or was told to
    raise instead of degrading), or a kernel library could not be built or
    loaded. ``__cause__`` carries the original error."""


class AdmissionRejected(SpgemmError, RuntimeError):
    """The serving tier refused a request at the door: the bounded admission
    queue is full or the deadline is already infeasible given the backlog.
    Raised before any device work."""


class DeadlineExceeded(SpgemmError, TimeoutError):
    """An admitted request's deadline expired before its batch dispatched.
    Subclasses ``TimeoutError`` so generic timeout handling composes."""


class SpgemmConfigError(SpgemmError, ValueError):
    """A caller passed an invalid knob, mode, name, or option combination
    (unknown kernel/policy/placement strings, malformed config fields,
    out-of-range parameters), or an option that a later slice of the port
    brings (``mesh=``)."""


class TrainingDivergedError(SpgemmError, RuntimeError):
    """The training loop's loss went non-finite: the typed, intentional
    abort of a trainer (distinct from ``KernelFallbackError``)."""


def resolve_mode(mode: str | None) -> str:
    """Normalize a ``validate=`` argument to a concrete mode.

    ``None`` defers to ``$REPRO_VALIDATE`` (else "off"); anything outside
    ``VALIDATE_MODES`` raises ``SpgemmConfigError``.
    """
    if mode is None:
        mode = os.environ.get(VALIDATE_ENV_VAR, "off") or "off"
    if mode not in VALIDATE_MODES:
        raise SpgemmConfigError(
            f"unknown validate mode {mode!r}; expected one of "
            f"{VALIDATE_MODES}")
    return mode


# --------------------------------------------------------------------------
# CSR invariant checks
# --------------------------------------------------------------------------

# Violation bits shared by the host and device checkers, so both modes raise
# identical typed errors for identical corruptions.
_BIT_INDPTR = 1  # indptr[0] != 0, negative row size, or negative nnz
_BIT_OVERFLOW = 2  # indptr[-1] > nnz_cap
_BIT_COL_OOB = 4  # live column index outside [0, k)
_BIT_NONFINITE = 8  # live value is NaN or +/-Inf


def csr_flags_device(indptr: torch.Tensor, indices: torch.Tensor,
                     values: torch.Tensor, k: int, check_finite: bool) -> torch.Tensor:
    """The invariant sweep on the operands' device: a 0-d int32 flag word,
    not yet read (the caller's one host read)."""
    nnz_cap = indices.shape[0]
    nnz = indptr[-1].long()
    d = indptr[1:] - indptr[:-1]
    bad_indptr = (indptr[0] != 0) | (d < 0).any() | (nnz < 0)
    overflow = nnz > nnz_cap
    live = torch.arange(nnz_cap, device=indices.device) < nnz.clamp(0, nnz_cap)
    col_oob = (live & ((indices < 0) | (indices >= k))).any()
    flags = (bad_indptr.int() * _BIT_INDPTR | overflow.int() * _BIT_OVERFLOW
             | col_oob.int() * _BIT_COL_OOB)
    if check_finite:
        nonfinite = (live & ~torch.isfinite(values)).any()
        flags = flags | nonfinite.int() * _BIT_NONFINITE
    return flags


def _raise_for_flags(flags: int, name: str, mat) -> None:
    if flags & _BIT_INDPTR:
        raise SpgemmInputError(
            f"{name}: corrupted indptr (must start at 0 and be "
            f"non-decreasing; m={mat.m}, nnz_cap={mat.nnz_cap})")
    if flags & _BIT_OVERFLOW:
        raise CapacityOverflowError(
            f"{name}: indptr[-1] exceeds the nnz capacity "
            f"{mat.nnz_cap} — the bucketed value buffer would overflow")
    if flags & _BIT_COL_OOB:
        raise SpgemmInputError(
            f"{name}: live column index outside [0, {mat.k})")
    if flags & _BIT_NONFINITE:
        raise SpgemmInputError(f"{name}: live value is NaN or Inf")


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def check_csr(mat, mode: str = "host", name: str = "operand"):
    """Validate a CSR operand under ``mode``; returns ``mat`` unchanged.

    Metadata checks (shape sanity, array-length agreement) read static
    shapes only and run in both modes. Content checks (indptr monotonicity,
    column bounds, value finiteness) run per the mode. Raises
    ``SpgemmInputError`` / ``CapacityOverflowError``; "off" is a no-op.
    """
    mode = resolve_mode(mode)
    if mode == "off":
        return mat
    shape = tuple(mat.shape)
    if len(shape) != 2 or any(int(s) < 0 for s in shape):
        raise SpgemmInputError(
            f"{name}: shape must be a non-negative (m, k) pair, got {shape}")
    m, k = (int(s) for s in shape)
    if mat.indptr.shape[0] != m + 1:
        raise SpgemmInputError(
            f"{name}: len(indptr) == {mat.indptr.shape[0]} but shape[0]+1 "
            f"== {m + 1}")
    if mat.indices.shape[0] != mat.values.shape[0]:
        raise SpgemmInputError(
            f"{name}: len(indices) == {mat.indices.shape[0]} != "
            f"len(values) == {mat.values.shape[0]}")
    check_finite = mat.values.is_floating_point()
    if mode == "device":
        flags = int(csr_flags_device(mat.indptr, mat.indices, mat.values, k,
                                     check_finite))
        _raise_for_flags(flags, name, mat)
        return mat
    # host mode: copies to numpy, exact first-violation indices in the message
    ip = _host(mat.indptr).astype(np.int64)
    if int(ip[0]) != 0:
        raise SpgemmInputError(f"{name}: indptr[0] == {int(ip[0])}, want 0")
    d = np.diff(ip)
    bad = np.nonzero(d < 0)[0]
    if bad.size:
        i = int(bad[0])
        raise SpgemmInputError(
            f"{name}: indptr not monotone at row {i} "
            f"({int(ip[i])} -> {int(ip[i + 1])})")
    nnz = int(ip[-1])
    if nnz > mat.nnz_cap:
        raise CapacityOverflowError(
            f"{name}: indptr[-1] == {nnz} exceeds nnz_cap == {mat.nnz_cap}")
    idx = _host(mat.indices[:nnz])
    bad = np.nonzero((idx < 0) | (idx >= k))[0]
    if bad.size:
        i = int(bad[0])
        raise SpgemmInputError(
            f"{name}: column index {int(idx[i])} at slot {i} outside "
            f"[0, {k})")
    if check_finite:
        vals = _host(mat.values[:nnz])
        bad = np.nonzero(~np.isfinite(vals))[0]
        if bad.size:
            raise SpgemmInputError(
                f"{name}: non-finite value at slot {int(bad[0])} "
                f"({vals[int(bad[0])]!r})")
    return mat


# --------------------------------------------------------------------------
# Plan <-> operand compatibility (replay-time checks)
# --------------------------------------------------------------------------


class PlanGuard:
    """Pin-time digest of a plan's operand requirements.

    Built once when an executor pins a plan with validation on: the digest
    is computed on the plan's device and read with one host read, so every
    later ``apply`` pays only O(1) host comparisons (plus a finiteness
    sweep in "device" mode).
    """

    def __init__(self, plan):
        self.nnz_cap = int(plan.indices.shape[0])
        # operand requirements come from LIVE products only: padding slots
        # carry the sentinel seg_id nnz_cap and are dropped by the replay
        live = plan.seg_ids < self.nnz_cap
        ip = plan.indptr.long()
        d = ip[1:] - ip[:-1]
        digest = torch.stack([
            torch.where(live, plan.a_slot_s.long(), -1).max() + 1
            if live.numel() else torch.zeros((), dtype=torch.long, device=ip.device),
            torch.where(live, plan.b_slot_s.long(), -1).max() + 1
            if live.numel() else torch.zeros((), dtype=torch.long, device=ip.device),
            ((ip[0] != 0) | (d < 0).any()).long(),
            ip[-1],
        ]).tolist()
        self.a_req, self.b_req, bad_indptr, nnz = (int(x) for x in digest)
        if bad_indptr:
            raise SpgemmInputError(
                "plan: corrupted indptr (must start at 0 and be "
                "non-decreasing) — refusing to pin")
        if nnz > self.nnz_cap:
            raise CapacityOverflowError(
                f"plan: indptr[-1] == {nnz} exceeds the plan's "
                f"nnz_cap == {self.nnz_cap}")

    def _check_one(self, values, req: int, side: str, mode: str,
                   batched: bool) -> None:
        want_ndim = values.ndim in (1, 2) if batched else values.ndim == 1
        if not want_ndim:
            raise PlanMismatchError(
                f"{side} values must be "
                f"{'(batch, nnz) or (nnz,)' if batched else '1-D (nnz,)'}, "
                f"got shape {tuple(values.shape)}")
        if values.shape[-1] < req:
            raise PlanMismatchError(
                f"{side} value buffer has {values.shape[-1]} slots but the "
                f"pinned plan gathers up to slot {req - 1} — replaying a "
                f"plan against operands from a different structure?")
        if mode == "device" and values.is_floating_point():
            if not bool(torch.isfinite(values).all()):
                raise SpgemmInputError(
                    f"{side} values contain NaN/Inf (device validation)")

    def check_values(self, a_values, b_values, mode: str,
                     batched: bool = False) -> None:
        """Replay-time operand check: shapes/lengths against the pinned
        requirements (``PlanMismatchError``), plus a device finiteness sweep
        in "device" mode (``SpgemmInputError``)."""
        self._check_one(a_values, self.a_req, "A", mode, batched)
        self._check_one(b_values, self.b_req, "B", mode, batched)


def check_plan_compat(pinned_key: str | None, a, b, fm_cap: int,
                      pad_policy: str) -> None:
    """Full structure-key recheck: do these operands still hash to the plan?

    Costs one ``structure_key`` digest (``HASH_COUNTS`` bumps).
    """
    from repro_torch.core.plan_cache import structure_key  # cycle-free late import

    if pinned_key is None:
        raise PlanMismatchError(
            "this executor has no pinned structure key (constructed from a "
            "bare plan); build it with ReuseExecutor.pin/from_matrices to "
            "enable the structure-key recheck")
    key = structure_key(a, b, fm_cap, pad_policy)
    if key != pinned_key:
        raise PlanMismatchError(
            f"operand structure key {key[:12]}... does not match the pinned "
            f"plan's {pinned_key[:12]}... — the plan would replay against a "
            f"different sparsity structure")
