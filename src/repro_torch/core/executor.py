"""Pinned plans, batched replay, grouping (port of ``repro/core/executor.py``).

``ReuseExecutor`` pins a plan once (one ``structure_key`` call, ever) and
replays it on new operand values:

  * ``apply(a_values, b_values)`` runs one replay through the pinned
    backend;
  * ``apply_batched`` replays stacked values ``(batch, nnz)`` with the batch
    dimension written out (batched gathers, then ``index_add_`` along dim 1);
  * ``spgemm_grouped`` groups a mixed batch by structure and replays each
    group once.

Backends keep the reference's names (``kernels.BACKEND_NAMES`` says what
each runs here): "xla" is the plain torch ``numeric_reuse`` and what "auto"
resolves to, "pallas" the CUDA ``segsum_reuse`` kernel, "pallas_lp" the CUDA
``lp_reuse`` kernel. The kernels accumulate in f32, so f64/int operands take
the plain path and bump ``FALLBACK_COUNTS["dtype:executor->xla"]``. Batched
replay always runs the plain path, as in the reference.

There is no degradation ladder in this slice: a kernel whose launch fails
raises ``KernelFallbackError`` from its wrapper, and a kernel that cannot be
built raises from ``kernels._build`` (the reference's
``on_kernel_failure="raise"``).
``on_kernel_failure="fallback"``, ``nan_guard``, ``watchdog``, ``validate``
and ``tune`` raise ``SpgemmConfigError`` until the port's runtime/ and
autotune slices land.
"""
from __future__ import annotations

from collections import Counter, OrderedDict
from typing import Sequence

import torch

from repro_torch.core.meta import DEFAULT_PAD_POLICY, f32_accumulation_ok
from repro_torch.core.plan_cache import default_plan_cache, structure_key
from repro_torch.core.spgemm import (
    SpgemmPlan,
    _note_stage,
    _reject_later_slice_options as _reject_spgemm_options,
    gather_clamped,
    lp_replay_values,
    numeric_reuse,
    prepare_sparse_inputs,
    resolve_plan,
    spgemm,
)
from repro_torch.kernels.segsum_reuse import segsum_reuse
from repro_torch.runtime.validate import PlanMismatchError, SpgemmConfigError
from repro_torch.sparse.formats import CSR

BACKENDS = ("auto", "xla", "pallas", "pallas_lp")

# Dispatch telemetry: counts calls, so tests can assert that grouping issues
# one batched replay per structure.
DISPATCH_COUNTS: Counter = Counter()

_DONATE = (False, True, "both", "a", "b")


def reset_dispatch_counts() -> None:
    DISPATCH_COUNTS.clear()


def _resolve_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise SpgemmConfigError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    # "auto" stays on the plain path, as in the reference: the kernels are
    # explicit opt-in
    return "xla" if backend == "auto" else backend


def _replay(plan: SpgemmPlan, a_values, b_values, backend: str):
    _note_stage("executor_apply")
    if backend == "pallas_lp":
        return lp_replay_values(plan, a_values, b_values)[0]
    if backend == "pallas" and f32_accumulation_ok(a_values.dtype, b_values.dtype):
        return segsum_reuse(plan, a_values, b_values)
    # the plain path: also where f64 and integer operands go, which the
    # f32-accumulating kernels must not see
    return numeric_reuse(plan, a_values, b_values)


def _replay_batched(plan: SpgemmPlan, a_values, b_values):
    """The reference's vmapped ``numeric_reuse`` with the batch written out:
    either operand is (batch, n) or shared (n,)."""
    _note_stage("executor_apply_batched")
    acc_dtype = torch.promote_types(a_values.dtype, b_values.dtype)
    prod = (gather_clamped(a_values, plan.a_slot_s).to(acc_dtype)
            * gather_clamped(b_values, plan.b_slot_s).to(acc_dtype))
    nnz_cap = plan.indices.shape[0]
    out = torch.zeros(prod.shape[0], nnz_cap + 1, dtype=acc_dtype,
                      device=prod.device)
    out.index_add_(1, plan.seg_ids, prod)
    return out[:, :nnz_cap]


def _reject_later_slice_options(tune, validate, nan_guard, watchdog,
                                on_kernel_failure) -> None:
    _reject_spgemm_options(mesh=None, tune=tune, validate=validate, trace=None)
    if nan_guard or watchdog is not None:
        raise SpgemmConfigError(
            "nan_guard and watchdog come with the port's runtime/ slice "
            "(ROADMAP Queue 1)")
    if on_kernel_failure != "raise":
        raise SpgemmConfigError(
            f"on_kernel_failure={on_kernel_failure!r}: the port has no "
            f"degradation ladder until its runtime/ slice, so a failed "
            f"kernel always raises KernelFallbackError ('raise')")


class ReuseExecutor:
    """A pinned ``SpgemmPlan`` exposed as a replay engine.

    Construction is the only host-side work: every later ``apply`` /
    ``apply_batched`` replays the plan with zero structure hashing and zero
    cache probes.
    """

    def __init__(self, plan: SpgemmPlan, *, backend: str = "auto",
                 tune: str | None = None, validate: str | None = "off",
                 nan_guard: bool = False, watchdog=None,
                 on_kernel_failure: str = "raise"):
        if plan is None:
            raise SpgemmConfigError(
                "ReuseExecutor needs a SpgemmPlan; got None — build the plan "
                "with spgemm(method='sparse')")
        _reject_later_slice_options(tune, validate, nan_guard, watchdog,
                                    on_kernel_failure)
        self.plan = plan
        self.backend = _resolve_backend(backend)
        self.on_kernel_failure = on_kernel_failure
        self._skey: str | None = None  # set by from_matrices/pin
        self._pad_policy: str | None = None
        self._fm_cap: int | None = None

    @classmethod
    def from_matrices(cls, a: CSR, b: CSR, *, pad_policy: str | None = None,
                      plan_cache=None, backend: str = "auto",
                      tune: str | None = None, validate: str | None = "off",
                      nan_guard: bool = False, watchdog=None,
                      on_kernel_failure: str = "raise") -> "ReuseExecutor":
        """Build (or fetch from the plan cache) the plan for ``a @ b`` and pin
        it: the one structure hash of the executor's life. The key is kept
        for ``check_compat``."""
        _reject_later_slice_options(tune, validate, nan_guard, watchdog,
                                    on_kernel_failure)
        res = spgemm(a, b, method="sparse", pad_policy=pad_policy,
                     plan_cache=plan_cache)
        ex = cls(res.plan, backend=backend, on_kernel_failure=on_kernel_failure)
        ex._skey = res.stats["structure_key"]
        ex._pad_policy = res.stats["pad_policy"]
        ex._fm_cap = res.stats["fm_cap"]
        return ex

    # the serving-facing name for pinning a plan from operands
    pin = from_matrices

    def check_compat(self, a: CSR, b: CSR) -> None:
        """Structure-key recheck: would these operands rebuild *this* plan?
        Raises ``PlanMismatchError`` if not, or if the executor was built
        from a bare plan. Costs one ``structure_key`` digest."""
        policy = self._pad_policy or DEFAULT_PAD_POLICY
        a, b, _, _, fm_cap = prepare_sparse_inputs(a, b, policy)
        if self._skey is None:
            raise PlanMismatchError(
                "this executor has no pinned structure key (constructed from "
                "a bare plan); build it with ReuseExecutor.pin/from_matrices "
                "to enable the structure-key recheck")
        if fm_cap != self._fm_cap:
            raise PlanMismatchError(
                f"operand expansion bucket fm_cap={fm_cap} != the pinned "
                f"plan's {self._fm_cap}")
        key = structure_key(a, b, fm_cap, policy)
        if key != self._skey:
            raise PlanMismatchError(
                f"operand structure key {key[:12]}... does not match the "
                f"pinned plan's {self._skey[:12]}... — the plan would replay "
                f"against a different sparsity structure")

    @property
    def shape(self) -> tuple:
        return tuple(self.plan.shape)

    @property
    def nnz_cap(self) -> int:
        return self.plan.indices.shape[0]

    @property
    def fm_cap(self) -> int:
        return self.plan.seg_ids.shape[0]

    def apply(self, a_values: torch.Tensor, b_values: torch.Tensor, *,
              donate: bool | str = False) -> torch.Tensor:
        """Replay the pinned plan on new operand values: (nnz_cap,) C values.

        ``donate`` takes the reference's values (False, True, "both", "a",
        "b") and is a no-op: eager PyTorch allocates the output anew and
        never aliases an input into it.
        """
        DISPATCH_COUNTS["apply"] += 1
        if donate not in _DONATE:
            raise SpgemmConfigError(
                f"donate must be bool, 'a', 'b' or 'both'; got {donate!r}")
        backend = self.backend
        if backend in ("pallas", "pallas_lp") and not f32_accumulation_ok(
                a_values.dtype, b_values.dtype):
            from repro_torch.core.telemetry import FALLBACK_COUNTS

            FALLBACK_COUNTS["dtype:executor->xla"] += 1
        return _replay(self.plan, a_values, b_values, backend)

    def apply_batched(self, a_values: torch.Tensor,
                      b_values: torch.Tensor) -> torch.Tensor:
        """Replay over stacked values: (batch, nnz_cap).

        Either operand may be stacked ``(batch, operand_nnz_cap)`` or shared
        ``(operand_nnz_cap,)``; at least one must be stacked. Always the
        plain path.
        """
        DISPATCH_COUNTS["apply_batched"] += 1
        if a_values.ndim != 2 and b_values.ndim != 2:
            raise SpgemmConfigError(
                "apply_batched needs at least one stacked (batch, nnz) operand; "
                "use apply() for a single replay")
        return _replay_batched(self.plan, a_values, b_values)

    def to_csr(self, values: torch.Tensor) -> CSR:
        """Wrap one replay's values in the plan's C structure."""
        return CSR(indptr=self.plan.indptr, indices=self.plan.indices,
                   values=values, shape=self.shape)


def spgemm_grouped(pairs: Sequence[tuple[CSR, CSR]], *,
                   pad_policy: str | None = None, plan_cache=None,
                   backend: str = "auto",
                   tune: str | None = None) -> list[CSR]:
    """Mixed-structure batch: group by structure, one replay per group.

    Each (A, B) multiply is hashed once with ``structure_key``; multiplies
    that share a structure and operand value dtypes are stacked and replayed
    through one ``apply_batched``. Results come back in input order.
    """
    _reject_spgemm_options(mesh=None, tune=tune, validate=None, trace=None)
    policy = DEFAULT_PAD_POLICY if pad_policy is None else pad_policy
    pairs = list(pairs)
    if not pairs:
        return []  # an empty batch is a legal no-op
    if plan_cache is None:
        cache = default_plan_cache()
    elif plan_cache is False:
        cache = None
    else:
        cache = plan_cache

    prepared: list[tuple[CSR, CSR, int]] = []
    groups: OrderedDict[tuple, list[int]] = OrderedDict()
    for a, b in pairs:
        a, b, _, _, fm_cap = prepare_sparse_inputs(a, b, policy)
        skey = structure_key(a, b, fm_cap, policy)  # the one hash per multiply
        # dtypes join the grouping (not the plan key): stacking a mixed group
        # would silently promote
        gkey = (skey, str(a.values.dtype), str(b.values.dtype))
        groups.setdefault(gkey, []).append(len(prepared))
        prepared.append((a, b, fm_cap))

    results: list[CSR | None] = [None] * len(prepared)
    for (skey, _, _), idxs in groups.items():
        a0, b0, fm_cap = prepared[idxs[0]]
        plan, _, _ = resolve_plan(a0, b0, fm_cap, policy, cache, key=skey)
        ex = ReuseExecutor(plan, backend=backend)
        if len(idxs) == 1:
            results[idxs[0]] = ex.to_csr(ex.apply(a0.values, b0.values))
            continue
        a_stack = torch.stack([prepared[i][0].values for i in idxs])
        b_stack = torch.stack([prepared[i][1].values for i in idxs])
        vals = ex.apply_batched(a_stack, b_stack)
        for j, i in enumerate(idxs):
            results[i] = ex.to_csr(vals[j])
    return results
