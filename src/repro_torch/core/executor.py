"""Pinned plans, batched replay, grouping (port of ``repro/core/executor.py``).

``ReuseExecutor`` pins a plan once (one ``structure_key`` call, ever) and
replays it on new operand values:

  * ``apply(a_values, b_values)`` runs one replay through the pinned
    backend;
  * ``apply_batched`` replays stacked values ``(batch, nnz)`` in one
    dispatch: on the card with "pallas" or "pallas_lp", one batched launch
    of that kernel; elsewhere the plain formulation with the batch dimension
    written out (batched gathers, then ``index_add_`` along dim 1);
  * ``spgemm_grouped`` groups a mixed batch by structure and replays each
    group once.

Backends keep the reference's names (``kernels.BACKEND_NAMES`` says what
each runs here): "xla" is the plain torch ``numeric_reuse`` and what "auto"
resolves to, "pallas" the CUDA ``segsum_reuse`` kernel, "pallas_lp" the CUDA
``lp_reuse`` kernel. The kernels accumulate in f32, so f64/int operands take
the plain path and bump ``FALLBACK_COUNTS["dtype:executor->xla"]``. Batched
replay runs the plain path on the CPU, as in the reference (whose batched
replay is always its vmapped XLA formulation); on the card a kernel backend
runs its batched kernel, under the same ladder as ``apply``.

The reference's selection and robustness options, with its defaults:
``tune="measure"`` times the eligible replay backends on the first
operands (``replay_candidates``) and pins the winner; ``validate=`` builds a
``PlanGuard`` at pin time; ``nan_guard=True`` reruns a non-finite output and
classifies it (``nan_guard:rerun``, ``:recovered``, ``:data``); ``watchdog=``
deadlines each replay, synchronising the card inside the step;
``on_kernel_failure="fallback"`` turns a kernel failure (a CUDA error of the
launch, an armed failpoint) into one step down the ladder on the same device
(``runtime.ladder``), counted as ``FALLBACK_COUNTS["fault:<backend>-><next>"]``,
where "raise" gives ``KernelFallbackError``. A kernel library that cannot be
built or loaded raises its typed ``KernelFallbackError`` through the ladder:
a broken build is never a rung.

Where the plain replay stands in for a kernel, the CPU and the card differ.
On the CPU it is the reference's: the next rung after a kernel, a measured
candidate, and the nan guard's rerun. On the card none of the three: the two
replay kernels are each the other's rung and rerun, and only they are
measured; the plain replay runs there only as the backend a caller picks
("xla", "auto") or where the dtype guard sends f64/int operands.
"""
from __future__ import annotations

import time
from collections import Counter, OrderedDict
from typing import Sequence

import torch

from repro_torch.core import autotune
from repro_torch.core.meta import DEFAULT_PAD_POLICY, f32_accumulation_ok
from repro_torch.core.plan_cache import default_plan_cache, structure_key
from repro_torch.core.spgemm import (
    SpgemmPlan,
    _note_stage,
    lp_replay_values,
    numeric_reuse,
    prepare_sparse_inputs,
    resolve_plan,
    spgemm,
)
from repro_torch.core.utils import block_until_ready
from repro_torch.kernels.segsum_reuse import (replay_batched_plain, segsum_reuse,
                                              segsum_reuse_batched)
from repro_torch.kernels.spgemm_lp import lp_reuse_batched
from repro_torch.obs import recorder
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import ladder
from repro_torch.runtime.validate import (
    PlanGuard,
    PlanMismatchError,
    SpgemmConfigError,
    check_plan_compat,
    resolve_mode,
)
from repro_torch.sparse.formats import CSR

BACKENDS = ("auto", "xla", "pallas", "pallas_lp")
# On the card a failed replay kernel steps to the other one.
OTHER_KERNEL = {"pallas": "pallas_lp", "pallas_lp": "pallas"}

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


def replay_candidates(plan, a_values, b_values) -> dict:
    """The eligible replay backends for these operands, as autotuner thunks.

    The f32-accumulating kernels ("pallas", "pallas_lp") only when
    ``f32_accumulation_ok`` admits the operand dtypes: measure mode must
    never time (let alone pick) a kernel the dtype guard would refuse to
    dispatch. "xla" on the CPU, as in the reference, and on the card only
    where the dtype guard leaves no kernel.
    """
    names = ["pallas", "pallas_lp"] if f32_accumulation_ok(a_values.dtype,
                                                           b_values.dtype) else []
    if not (names and ladder.kernels_only(a_values.device)):
        names.insert(0, "xla")
    return {nm: (lambda nm=nm: _replay(plan, a_values, b_values, nm)) for nm in names}


def replay_rungs(backend: str, on_card: bool) -> list[str]:
    """The replay ladder's rungs from ``backend``: on the CPU a kernel steps
    to "xla", as in the reference; on the card to the other kernel. "xla"
    is its own last rung."""
    if backend not in OTHER_KERNEL:
        return [backend]
    return [backend, OTHER_KERNEL[backend] if on_card else "xla"]


def measured_replay_backend(plan, a_values, b_values, cache=None,
                            cache_key: str | None = None) -> str:
    """The measured-fastest replay backend for these operands, resolved in
    order (each layer spares the next its work):

      1. the plan-cache entry's sidecar meta (dtype-qualified: the
         structure key leaves value dtypes out on purpose), when ``cache``
         and ``cache_key`` are given;
      2. the autotuner's structure-stats bucket table;
      3. a first-sight micro-bench of ``replay_candidates`` on these
         operands, recorded in the bucket table.

    A winner found in 2 or 3 is written back to the plan-cache entry, so
    later calls re-dispatch it with zero re-tuning.
    """
    meta_key = ("tuned_backend", str(a_values.dtype), str(b_values.dtype))
    if cache is not None:
        winner = cache.get_meta(cache_key, meta_key)
        if winner is not None:
            autotune.TUNE_COUNTS["plan_meta_hit"] += 1
            return winner
    m, k = (int(x) for x in plan.shape)
    bkey = autotune.bucket_key(m, k, plan.seg_ids.shape[0], a_values.dtype,
                               b_values.dtype, table="replay", device=a_values.device)
    winner = autotune.lookup_measured(bkey)
    if winner is None:
        winner, _ = autotune.measure_and_record(
            bkey, replay_candidates(plan, a_values, b_values))
    if cache is not None:
        cache.set_meta(cache_key, meta_key, winner)
    return winner


def _replay_batched(plan: SpgemmPlan, a_values, b_values):
    """The reference's vmapped ``numeric_reuse`` with the batch written out:
    either operand is (batch, n) or shared (n,); sums in
    ``promote_types(a, b)``. The plain version of both batched kernels (for
    operands whose promoted type is f32 the same function)."""
    _note_stage("executor_apply_batched")
    return replay_batched_plain(plan.a_slot_s, plan.b_slot_s, plan.seg_ids, a_values,
                                b_values, plan.indices.shape[0],
                                acc_dtype=torch.promote_types(a_values.dtype, b_values.dtype))


def _replay_batched_kernel(plan: SpgemmPlan, a_values, b_values, backend: str):
    """One batched launch of the replay kernel ``backend`` names."""
    if backend == "pallas":
        return segsum_reuse_batched(plan, a_values, b_values)
    return lp_reuse_batched(plan, a_values, b_values)


def _check_tune(tune, backend: str) -> None:
    autotune.validate_tune(tune)
    if tune == "measure" and backend != "auto":
        raise SpgemmConfigError(
            f"tune='measure' requires backend='auto' (got "
            f"backend={backend!r}): measure mode picks the backend "
            f"empirically, an explicit pin contradicts it")


class ReuseExecutor:
    """A pinned ``SpgemmPlan`` exposed as a replay engine.

    Construction is the only host-side work: every later ``apply`` /
    ``apply_batched`` replays the plan with zero structure hashing and zero
    cache probes.

    ``tune="measure"`` defers the backend choice to the first ``apply``:
    the autotuner's bucket table is consulted (a previous executor on a
    same-bucket problem already paid the sweep), else the eligible replay
    backends are timed once on the first real operands; every later
    ``apply`` dispatches the pinned winner. ``kernel_source`` records the
    provenance ("static", then "measured", or "fallback" after a ladder
    step, which ``last_step`` names, e.g. "pallas->pallas_lp"). Requires
    ``backend="auto"``. ``apply_batched`` takes the pinned backend as it
    stands: "auto" and "xla" the plain batched formulation.

    Robustness knobs (see the module docstring): ``validate``,
    ``nan_guard``, ``watchdog``, ``on_kernel_failure``.
    """

    def __init__(self, plan: SpgemmPlan, *, backend: str = "auto",
                 tune: str | None = None, validate: str | None = "off",
                 nan_guard: bool = False, watchdog=None,
                 on_kernel_failure: str = "fallback"):
        if plan is None:
            raise SpgemmConfigError(
                "ReuseExecutor needs a SpgemmPlan; got None — build the plan "
                "with spgemm(method='sparse')")
        _check_tune(tune, backend)
        ladder.check_policy(on_kernel_failure)
        self.plan = plan
        self.backend = _resolve_backend(backend)
        self.tune = tune
        self.kernel_source = "static"
        self.last_step: str | None = None  # the ladder's last "<failed>-><next>"
        self._needs_measure = tune == "measure"
        # the executor's default is a literal "off", not None: replay is the
        # hot path, and $REPRO_VALIDATE must not change it behind a serving
        # loop's back
        self.validate_mode = resolve_mode(validate)
        self.nan_guard = nan_guard
        self.watchdog = watchdog
        self.on_kernel_failure = on_kernel_failure
        self.nan_events: list[tuple] = []
        # pin-time plan digest: one host read here buys O(1) per-replay checks
        self._guard = PlanGuard(plan) if self.validate_mode != "off" else None
        self._skey: str | None = None  # set by from_matrices/pin
        self._pad_policy: str | None = None
        self._fm_cap: int | None = None

    @classmethod
    def from_matrices(cls, a: CSR, b: CSR, *, pad_policy: str | None = None,
                      plan_cache=None, backend: str = "auto",
                      tune: str | None = None, validate: str | None = "off",
                      nan_guard: bool = False, watchdog=None,
                      on_kernel_failure: str = "fallback") -> "ReuseExecutor":
        """Build (or fetch from the plan cache) the plan for ``a @ b`` and pin
        it: the one structure hash of the executor's life. The key is kept
        for ``check_compat``."""
        _check_tune(tune, backend)
        res = spgemm(a, b, method="sparse", pad_policy=pad_policy,
                     plan_cache=plan_cache, validate=validate)
        ex = cls(res.plan, backend=backend, tune=tune, validate=validate,
                 nan_guard=nan_guard, watchdog=watchdog,
                 on_kernel_failure=on_kernel_failure)
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
        if self._skey is not None and fm_cap != self._fm_cap:
            raise PlanMismatchError(
                f"operand expansion bucket fm_cap={fm_cap} != the pinned "
                f"plan's {self._fm_cap}")
        check_plan_compat(self._skey, a, b, fm_cap, policy)

    def _measure(self, a_values: torch.Tensor, b_values: torch.Tensor) -> None:
        """First-apply backend measurement (tune="measure" only): the bucket
        table first, else a sweep of the eligible backends on these
        operands, recorded for the bucket. The winner is pinned."""
        self.backend = measured_replay_backend(self.plan, a_values, b_values)
        self.kernel_source = "measured"
        self._needs_measure = False

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
        never aliases an input into it. As in the reference it does not
        combine with ``nan_guard``.
        """
        DISPATCH_COUNTS["apply"] += 1
        if self._needs_measure:
            self._measure(a_values, b_values)
        if donate not in _DONATE:
            raise SpgemmConfigError(
                f"donate must be bool, 'a', 'b' or 'both'; got {donate!r}")
        if donate and self.nan_guard:
            raise SpgemmConfigError(
                "nan_guard and donate are incompatible: the guard's rerun "
                "reads the operand buffers after dispatch, which donation "
                "invalidates")
        if self._guard is not None:
            self._guard.check_values(a_values, b_values, self.validate_mode)
        out = self._dispatch(a_values, b_values)
        if self.nan_guard:
            out = self._nan_check(out, a_values, b_values)
        return out

    def _dispatch(self, a_values, b_values):
        """One replay under the degradation ladder and the watchdog. With
        tracing off this is the bare ladder; with it on, a
        ``numeric.dispatch`` span and a flight-recorder event."""
        backend = self.backend
        if backend in ("pallas", "pallas_lp") and not f32_accumulation_ok(
                a_values.dtype, b_values.dtype):
            from repro_torch.core.telemetry import FALLBACK_COUNTS  # cycle-free

            FALLBACK_COUNTS["dtype:executor->xla"] += 1
        if not obs_trace.enabled():
            return self._run_ladder(a_values, b_values, backend)
        t0 = time.perf_counter()
        with obs_trace.span("numeric.dispatch", kernel=backend,
                            site="executor") as sp:
            out = self._run_ladder(a_values, b_values, backend, sp=sp)
        recorder.record(
            "dispatch", kernel=self.backend, structure_key=self._skey,
            shapes=f"{tuple(a_values.shape)}x{tuple(b_values.shape)}",
            duration_s=time.perf_counter() - t0,
            verdict=("fallback" if sp.attrs.get("fallback") else "ok"),
            trace_id=obs_trace.current_trace_id())
        return out

    def _run_ladder(self, a_values, b_values, backend, sp=None, batched=False):
        """The degradation ladder proper (``replay_rungs``), each rung one
        replay (one batched launch for ``apply_batched``). Typed errors (a
        kernel library that cannot be built included) and watchdog verdicts
        pass through."""
        replay = _replay_batched_kernel if batched else _replay

        def stepped(step: str) -> None:
            self.kernel_source = "fallback"
            self.last_step = step
            if sp is not None:
                sp.set("fallback", step)

        out, _ = ladder.walk(
            replay_rungs(backend, ladder.kernels_only(a_values.device)),
            lambda name: self._timed(lambda: replay(self.plan, a_values, b_values, name)),
            on_kernel_failure=self.on_kernel_failure, site="executor",
            what="replay backend", on_step=stepped, structure_key=self._skey)
        return out

    def _timed(self, run):
        """``run()``, under the watchdog's deadline when one is set: the
        guarded step synchronises the card, so it times the finished result."""
        if self.watchdog is None:
            return run()
        with self.watchdog.step(DISPATCH_COUNTS["apply"]
                                + DISPATCH_COUNTS["apply_batched"]):
            return block_until_ready(run())

    def _nan_check(self, out, a_values, b_values):
        """Opt-in output guard: on a non-finite output, rerun once and
        classify — "recovered" (the rerun's output is finite: a kernel-side
        fault, the rerun is returned) or "data" (the operands carry NaN/Inf:
        flagged, the rerun is returned). The rerun is the plain replay on
        the CPU; on the card a replay kernel's rerun is the other kernel."""
        if not out.is_floating_point() or bool(torch.isfinite(out).all()):
            return out
        from repro_torch.core.telemetry import FALLBACK_COUNTS  # cycle-free

        FALLBACK_COUNTS["nan_guard:rerun"] += 1
        rungs = replay_rungs(self.backend, ladder.kernels_only(a_values.device))
        oracle = (numeric_reuse(self.plan, a_values, b_values) if rungs[-1] == "xla"
                  else _replay(self.plan, a_values, b_values, rungs[-1]))
        if bool(torch.isfinite(oracle).all()):
            FALLBACK_COUNTS["nan_guard:recovered"] += 1
            self.nan_events.append(("recovered", self.backend))
            return oracle
        FALLBACK_COUNTS["nan_guard:data"] += 1
        self.nan_events.append(("data", self.backend))
        return oracle

    def apply_batched(self, a_values: torch.Tensor,
                      b_values: torch.Tensor) -> torch.Tensor:
        """Replay over stacked values in one dispatch: (batch, nnz_cap).

        Either operand may be stacked ``(batch, operand_nnz_cap)`` or shared
        ``(operand_nnz_cap,)``; at least one must be stacked. On the card,
        with backend "pallas" or "pallas_lp" and operands the dtype guard
        admits, one batched launch of that kernel under the degradation
        ladder (K1 <-> K2, ``fault:<k>-><other>``); f64/int operands there
        take the plain path and bump ``dtype:executor->xla``. Everywhere
        else (CPU tensors, "xla") the plain batched formulation, as in the
        reference.
        """
        DISPATCH_COUNTS["apply_batched"] += 1
        if a_values.ndim != 2 and b_values.ndim != 2:
            raise SpgemmConfigError(
                "apply_batched needs at least one stacked (batch, nnz) operand; "
                "use apply() for a single replay")
        if self._guard is not None:
            self._guard.check_values(a_values, b_values, self.validate_mode,
                                     batched=True)
        batch = a_values.shape[0] if a_values.ndim == 2 else b_values.shape[0]
        kernel = self.backend in OTHER_KERNEL and ladder.kernels_only(a_values.device)
        if kernel and not f32_accumulation_ok(a_values.dtype, b_values.dtype):
            from repro_torch.core.telemetry import FALLBACK_COUNTS  # cycle-free

            FALLBACK_COUNTS["dtype:executor->xla"] += 1
            kernel = False
        backend = self.backend if kernel else "xla"
        with obs_trace.span("numeric.dispatch", kernel=backend, site="executor",
                            batch=batch) as sp:
            if backend == "xla":
                return self._timed(lambda: _replay_batched(self.plan, a_values, b_values))
            return self._run_ladder(a_values, b_values, backend, sp=sp, batched=True)

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

    tune="measure": singleton groups dispatch the measured replay winner
    (``measured_replay_backend``: the plan-cache entry's recorded winner,
    else the bucket table, else a first-sight measurement, written back to
    the entry), as ``spgemm(tune="measure")`` does. Batched groups replay
    through ``apply_batched`` with the caller's ``backend``: on the card a
    kernel backend is one batched launch a group. Requires backend="auto".
    """
    _check_tune(tune, backend)
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
    for (skey, adt, bdt), idxs in groups.items():
        a0, b0, fm_cap = prepared[idxs[0]]
        plan, _, _ = resolve_plan(a0, b0, fm_cap, policy, cache, key=skey)
        if len(idxs) == 1:
            if tune == "measure":
                pinned = measured_replay_backend(plan, a0.values, b0.values, cache, skey)
                ex = ReuseExecutor(plan, backend=pinned)
            else:
                ex = ReuseExecutor(plan, backend=backend)
            results[idxs[0]] = ex.to_csr(ex.apply(a0.values, b0.values))
            continue
        ex = ReuseExecutor(plan, backend=backend)
        a_stack = torch.stack([prepared[i][0].values for i in idxs])
        b_stack = torch.stack([prepared[i][1].values for i in idxs])
        vals = ex.apply_batched(a_stack, b_stack)
        for j, i in enumerate(idxs):
            results[i] = ex.to_csr(vals[j])
    return results
