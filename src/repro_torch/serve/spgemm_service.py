"""Overload-safe SpGEMM request serving over the executor stack (port of
``repro/serve/spgemm_service.py``).

The paper's two-phase split is the shape of a serving workload: millions of
requests whose *structures* repeat, so the symbolic phase is paid once per
structure and every request replays a pinned plan. ``SparseService`` is that
workload's front door, built so its headline property is *graceful behavior
at and past saturation*:

  * **Bounded admission queue with backpressure.** ``submit`` never queues
    unboundedly: a full queue rejects with typed ``AdmissionRejected``.
    Deadline-aware load shedding happens at both ends — admission refuses a
    request whose deadline is infeasible given the measured backlog
    (``AdmissionRejected``), and the batch loop sheds queued requests whose
    deadline expired before dispatch (``DeadlineExceeded``). Every request
    gets a typed verdict; nothing is silently dropped.
  * **Validation at the door.** Operands are checked with
    ``runtime.validate.check_csr`` (default ``validate="host"``) at
    admission, so one corrupt request is rejected before it can poison a
    batched dispatch shared with healthy requests.
  * **Grouped dispatch over pinned plans.** Admitted requests are grouped by
    ``structure_key`` + operand dtypes (one hash per request, paid at
    admission); each group replays a pinned ``ReuseExecutor`` plan — one
    ``apply_batched`` dispatch per multi-request group, one ``apply`` per
    singleton — with plans resolved through the plan cache so repeated
    structures never re-expand. The batch loop handles the empty tick
    explicitly (an all-shed batch dispatches nothing).
  * **Per-kernel circuit breaker** (``serve.breaker``) on top of the
    degradation ladder: the ladder keeps a faulting fast kernel *correct*,
    the breaker keeps it *cheap* — repeated ``fault:*`` fallbacks open the
    breaker and subsequent traffic routes straight to the recorded-safe
    path; after a cooldown a half-open probe re-admits the fast path.
    Transitions land in ``telemetry.BREAKER_COUNTS``. Where the operands
    live decides the safe path and what the breaker governs (below).
  * **Watchdog + retry.** Every group dispatch runs under a shared
    ``StepWatchdog`` and ``runtime.retry.retry_call`` (label
    ``serve.dispatch`` in ``telemetry.RETRY_COUNTS``): transient failures —
    stragglers, injected chaos — are retried with bounded backoff;
    deterministic typed errors fail the group immediately; exhaustion is a
    typed ``RetryExhaustedError`` on every response in the group.
  * **Plan-cache warming** (``serve.warmer``): the service logs the
    structures it serves (zero extra hashes — the admission key is reused)
    and ``warm()`` prefetches the hottest plans; eviction mid-stream is
    tolerated everywhere (``resolve_plan`` transparently rebuilds, pinned
    executors keep their plans regardless).

Single-threaded by design: ``submit`` enqueues, ``step`` pumps one batch,
``drain`` runs until empty. Determinism is the chaos suite's foundation —
the clock is injectable, retry backoff is seeded, and there is no hidden
thread to race a failpoint. A calling loop provides the concurrency story by
interleaving submits and steps.

The CPU and the card route differently; nothing else differs:

  * **CPU tensors, or the "xla" backend: the reference's rules.** An open
    breaker routes singletons to "xla", the plain replay; batched groups
    take the plain batched replay and never consult the breaker; a degraded
    dispatch's ``serve.dispatch`` span says ``fallback="<k>->xla"``.
  * **CUDA tensors with a kernel backend** ("pallas" = K1, "pallas_lp" =
    K2; ``runtime.ladder.kernels_only``): every request is served by a
    replay kernel. A group of one runs ``apply``, a batched group ONE
    batched launch of the kernel (``apply_batched``), both under the
    breaker: one ``allow()`` and one verdict per group, so a broken kernel
    costs a batched group no more than a singleton. An open breaker routes
    to the other replay kernel (``executor.OTHER_KERNEL``), which
    ``response.backend`` names. The span's ``fallback`` attribute is the
    step the ladder took (``pallas->pallas_lp``), read from the executor;
    ``degraded`` is set exactly when the ladder stepped.

A kernel library that cannot be built (``kernels._build.KernelBuildError``)
fails the group at once: deterministic, it is never retried. Unlike the
reference the service takes no ``interpret=`` keyword (the port's
``ReuseExecutor`` has none). Each queued request holds its prepared
operands on their device until it is served: at ``max_queue`` 256 and
multigrid 2048^2 A*P operands (about 100 MB a request) that is tens of GB
of device memory.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict
from typing import Callable

import torch

from repro_torch.core.executor import BACKENDS, OTHER_KERNEL, ReuseExecutor
from repro_torch.core.meta import DEFAULT_PAD_POLICY
from repro_torch.core.plan_cache import PlanCache, structure_key
from repro_torch.core.spgemm import prepare_sparse_inputs, resolve_plan
from repro_torch.kernels._build import KernelBuildError
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import ladder
from repro_torch.runtime.retry import retry_call
from repro_torch.runtime.validate import (AdmissionRejected, DeadlineExceeded,
                                          KernelFallbackError, PlanMismatchError,
                                          SpgemmConfigError, SpgemmError,
                                          SpgemmInputError, check_csr, resolve_mode)
from repro_torch.runtime.watchdog import StepWatchdog
from repro_torch.serve.breaker import CircuitBreaker
from repro_torch.serve.warmer import TrafficLog, warm_plan_cache
from repro_torch.sparse.formats import CSR

RETRY_LABEL = "serve.dispatch"
# deterministic failures a group dispatch never retries: the reference's,
# and a kernel library that cannot be built
NO_RETRY = (SpgemmInputError, PlanMismatchError, KernelBuildError)


@dataclasses.dataclass
class SparseResponse:
    """The service's promise for one request; filled by the batch loop.

    Exactly one of ``value`` (a CSR product) / ``error`` (a typed
    ``SpgemmError``) is set once ``done``. ``backend``/``group_size``/
    ``degraded`` record how the dispatch ran (None/0/False for rejected
    requests that never dispatched). ``trace_id`` is the request's identity
    in the observability layer: every span the dispatch path opens for this
    request (admission, grouping, plan build, executor dispatch, retries)
    carries it, so an exported Chrome trace can be filtered to one request
    end-to-end.
    """

    request_id: int
    submitted_at: float
    priority: int = 0
    deadline_s: float | None = None
    trace_id: str | None = None
    done: bool = False
    value: CSR | None = None
    error: Exception | None = None
    completed_at: float | None = None
    backend: str | None = None
    group_size: int = 0
    degraded: bool = False

    @property
    def ok(self) -> bool:
        return self.done and self.error is None

    @property
    def latency_s(self) -> float | None:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at


@dataclasses.dataclass
class _Pending:
    """An admitted request waiting in the queue (operands already prepared
    and structure-hashed at admission)."""

    seq: int
    a: CSR  # prepared (capacity-bucketed) operands
    b: CSR
    fm_cap: int
    skey: str
    priority: int
    deadline: float | None  # absolute, on the service clock
    response: SparseResponse


class SparseService:
    """Bounded-queue, deadline-aware SpGEMM serving over pinned plans.

    backend: the fast replay path ("auto" resolves to "xla"; "pallas"/
        "pallas_lp" opt into the replay kernels K1/K2, guarded by a
        per-kernel circuit breaker). On the CPU batched groups take the
        plain batched replay and the breaker governs singletons, as in the
        reference; on the card batched groups run the batched kernel under
        the breaker too (module docstring).
    validate: admission-time operand validation mode (default "host" — the
        serving tier rejects corruption at the door; "off" is the caller's
        risk).
    max_queue / max_batch: admission bound (backpressure past it) and the
        largest request count one ``step`` dispatches.
    plan_cache: the structure-keyed plan LRU (default: a private
        ``PlanCache(name="serve")``); ``warm()`` prefetches into it.
    max_executors: LRU bound on pinned per-structure executors (each pins
        plan arrays on device — the cache must not hoard them).
    retries: transient-failure retries per group dispatch (via
        ``retry_call``; deterministic typed errors never retry).
    watchdog: a ``StepWatchdog`` for dispatch deadlines (default: 60 s,
        policy "warn" — a straggling replay is recorded, not killed; pass
        policy="raise" to convert stragglers into retried failures).
    breaker_*: circuit-breaker tuning for the fast kernel (threshold within
        a sliding window; cooldown before the half-open probe).
    clock: injectable monotonic clock (tests/chaos drive deadlines and
        cooldowns deterministically).
    """

    def __init__(self, *, backend: str = "auto", validate: str | None = "host",
                 max_queue: int = 256, max_batch: int = 16,
                 pad_policy: str | None = None, plan_cache: PlanCache | None = None,
                 max_executors: int = 32, retries: int = 1,
                 retry_base_delay_s: float = 0.01,
                 watchdog: StepWatchdog | None = None,
                 breaker_threshold: int = 3, breaker_window_s: float = 30.0,
                 breaker_cooldown_s: float = 5.0,
                 admission_slack: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 traffic_log: TrafficLog | None = None):
        if backend not in BACKENDS:
            raise SpgemmConfigError(
                f"unknown backend {backend!r}; expected one of {BACKENDS}")
        if max_queue < 1 or max_batch < 1:
            raise SpgemmConfigError(
                f"max_queue and max_batch must be >= 1, got "
                f"max_queue={max_queue}, max_batch={max_batch}")
        self.fast_backend = "xla" if backend == "auto" else backend
        self.validate_mode = resolve_mode(validate)
        self.max_queue = max_queue
        self.max_batch = max_batch
        self.pad_policy = DEFAULT_PAD_POLICY if pad_policy is None else pad_policy
        self.plan_cache = (PlanCache(capacity=32, name="serve")
                           if plan_cache is None else plan_cache)
        self.max_executors = max_executors
        self.retries = retries
        self.retry_base_delay_s = retry_base_delay_s
        self.watchdog = watchdog or StepWatchdog(deadline_s=60.0, policy="warn")
        self.admission_slack = admission_slack
        self.clock = clock
        self._sleep = sleep
        self.traffic_log = TrafficLog(self.pad_policy) if traffic_log is None \
            else traffic_log
        self._breakers: dict[str, CircuitBreaker] = {}
        if self.fast_backend != "xla":
            self._breakers[self.fast_backend] = CircuitBreaker(
                self.fast_backend, failure_threshold=breaker_threshold,
                window_s=breaker_window_s, cooldown_s=breaker_cooldown_s,
                clock=clock)
        self._queue: list[_Pending] = []
        self._executors: OrderedDict[str, ReuseExecutor] = OrderedDict()
        self._seq = 0
        # Per-service latency distributions: "serve.step" (batch-loop
        # tick) and "serve.request" (admission->completion). The step
        # histogram's median replaces the old single-EWMA wait estimator;
        # step_hint_s seeds the estimator before the first step lands (and is
        # what tests/benchmarks set to pin admission behavior).
        self.metrics = obs_metrics.MetricsRegistry(name="serve")
        self.step_hint_s: float | None = None
        self.counters = {
            "submitted": 0, "admitted": 0, "completed": 0, "failed": 0,
            "shed_queue_full": 0, "shed_deadline_infeasible": 0,
            "shed_deadline_expired": 0, "rejected_validation": 0,
            "steps": 0, "group_dispatches": 0, "degraded_dispatches": 0,
        }

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def _est_step_s(self) -> float | None:
        """Current step-latency estimate: the measured ``serve.step``
        histogram's median once real steps landed, else ``step_hint_s``
        (a caller-provided seed), else None (no information yet)."""
        h = self.metrics.histogram("serve.step")
        if h.count > 0:
            return h.percentile(50.0)
        return self.step_hint_s

    def _est_wait_s(self) -> float:
        """Predicted queue wait for a request admitted right now: estimated
        step latency x the number of batch ticks ahead of it. Zero until the
        first step lands (an idle service admits everything)."""
        est = self._est_step_s()
        if est is None:
            return 0.0
        ticks = math.ceil((len(self._queue) + 1) / self.max_batch)
        return ticks * est

    def _reject(self, resp: SparseResponse, err: SpgemmError,
                reason: str) -> SparseResponse:
        resp.done = True
        resp.error = err
        resp.completed_at = self.clock()
        self.counters[reason] += 1
        return resp

    def submit(self, a: CSR, b: CSR, *, deadline_s: float | None = None,
               priority: int = 0) -> SparseResponse:
        """Offer one multiply to the service; returns its response promise.

        Rejections complete the response immediately with a typed error
        (``AdmissionRejected`` for backpressure/infeasible deadlines, the
        validation taxonomy for corrupt operands) — ``submit`` itself never
        raises for per-request conditions, so a calling loop handles mixed
        outcomes uniformly.
        """
        now = self.clock()
        resp = SparseResponse(request_id=self._seq, submitted_at=now,
                              priority=priority, deadline_s=deadline_s,
                              trace_id=f"req-{self._seq}")
        self._seq += 1
        self.counters["submitted"] += 1
        if not obs_trace.enabled():
            return self._admit(a, b, resp, deadline_s, now)
        with obs_trace.trace_context(resp.trace_id):
            with obs_trace.span("serve.admit", request_id=resp.request_id):
                return self._admit(a, b, resp, deadline_s, now)

    def _admit(self, a: CSR, b: CSR, resp: SparseResponse,
               deadline_s: float | None, now: float) -> SparseResponse:
        """Admission proper (validation, prep, feasibility, enqueue) — split
        out of ``submit`` so tracing can wrap it without touching it."""
        if len(self._queue) >= self.max_queue:
            return self._reject(resp, AdmissionRejected(
                f"admission queue full ({self.max_queue} pending): "
                f"backpressure — shed upstream or retry later"),
                "shed_queue_full")
        if self.validate_mode != "off":
            try:
                check_csr(a, self.validate_mode, name="A")
                check_csr(b, self.validate_mode, name="B")
            except SpgemmError as e:
                return self._reject(resp, e, "rejected_validation")
        try:
            pa, pb, _, _, fm_cap = prepare_sparse_inputs(a, b, self.pad_policy)
        except SpgemmError as e:  # e.g. CapacityOverflowError from repad
            return self._reject(resp, e, "rejected_validation")
        if deadline_s is not None:
            est = self._est_wait_s() * self.admission_slack
            if est > deadline_s:
                return self._reject(resp, AdmissionRejected(
                    f"deadline {deadline_s:.4f}s infeasible: estimated "
                    f"queue wait {est:.4f}s at depth {len(self._queue)}"),
                    "shed_deadline_infeasible")
        skey = structure_key(pa, pb, fm_cap, self.pad_policy)
        self.traffic_log.record_prepared(skey, pa, pb, fm_cap)
        self._queue.append(_Pending(
            seq=resp.request_id, a=pa, b=pb, fm_cap=fm_cap, skey=skey,
            priority=resp.priority,
            deadline=None if deadline_s is None else now + deadline_s,
            response=resp))
        self.counters["admitted"] += 1
        return resp

    # ------------------------------------------------------------------
    # Batch loop
    # ------------------------------------------------------------------

    def _finish(self, p: _Pending, *, value: CSR | None = None,
                error: Exception | None = None, backend: str | None = None,
                group_size: int = 0, degraded: bool = False) -> None:
        r = p.response
        r.done = True
        r.value = value
        r.error = error
        r.completed_at = self.clock()
        r.backend = backend
        r.group_size = group_size
        r.degraded = degraded
        if error is None:
            self.counters["completed"] += 1
            self.metrics.observe("serve.request", r.latency_s)
        else:
            self.counters["failed"] += 1

    def _executor_for(self, p: _Pending) -> ReuseExecutor:
        """Pinned executor for one structure (LRU-bounded). A plan-cache
        eviction between steps is invisible here: an already-pinned executor
        keeps its plan, and a missing entry is transparently rebuilt by
        ``resolve_plan``."""
        ex = self._executors.get(p.skey)
        if ex is not None:
            self._executors.move_to_end(p.skey)
            return ex
        plan, _, _ = resolve_plan(p.a, p.b, p.fm_cap, self.pad_policy,
                                  self.plan_cache, key=p.skey)
        ex = ReuseExecutor(plan, backend="auto", watchdog=self.watchdog,
                           on_kernel_failure="fallback")
        self._executors[p.skey] = ex
        while len(self._executors) > self.max_executors:
            self._executors.popitem(last=False)
        return ex

    def _dispatch_group(self, items: list[_Pending]) -> None:
        """One structure+dtype group -> ONE device dispatch (plus ladder /
        retry re-dispatches), under breaker routing for singletons (and, on
        the card, for batched groups).

        Tracing: the group dispatch runs under the requests' trace IDs
        (``trace_context``), so the nested ``plan.build`` /
        ``numeric.dispatch`` / retry spans — and the flight-recorder events
        they leave — are attributable to the admitted requests end-to-end.
        """
        if not obs_trace.enabled():
            return self._dispatch_group_inner(items, None)
        tids = [p.response.trace_id for p in items]
        with obs_trace.trace_context(
                tids[0] if len(tids) == 1 else "+".join(tids)):
            with obs_trace.span("serve.dispatch", group=len(items),
                                structure_key=items[0].skey) as sp:
                return self._dispatch_group_inner(items, sp)

    def _route(self, items: list[_Pending]) -> tuple[CircuitBreaker | None, str]:
        """(the breaker this dispatch answers to, or None; the backend it
        takes). The CPU's rules are the reference's; on the card the breaker
        also governs batched groups and an open one routes to the other
        replay kernel."""
        if self.fast_backend == "xla":
            return None, "xla"
        on_card = ladder.kernels_only(items[0].a.values.device)
        if len(items) > 1 and not on_card:
            return None, "xla"
        breaker = self._breakers[self.fast_backend]
        if breaker.allow():
            return breaker, self.fast_backend
        return breaker, OTHER_KERNEL[self.fast_backend] if on_card else "xla"

    def _dispatch_group_inner(self, items: list[_Pending], sp) -> None:
        ex = self._executor_for(items[0])
        breaker, backend = self._route(items)
        took_fast = breaker is not None and backend == self.fast_backend
        ex.backend = backend
        ex.kernel_source = "static"
        ex.last_step = None
        if sp is not None:
            sp.set("kernel", backend)

        def dispatch():
            if len(items) == 1:
                p = items[0]
                return [ex.apply(p.a.values, p.b.values)]
            shapes = {(p.a.values.shape, p.b.values.shape) for p in items}
            if len(shapes) > 1:  # the group key holds the structure key
                raise PlanMismatchError(
                    f"a group's operand values differ in shape: {sorted(shapes)}")
            a_stack = torch.stack([p.a.values for p in items])
            b_stack = torch.stack([p.b.values for p in items])
            out = ex.apply_batched(a_stack, b_stack)
            return [out[i] for i in range(len(items))]

        self.counters["group_dispatches"] += 1
        try:
            vals = retry_call(dispatch, retries=self.retries,
                              base_delay_s=self.retry_base_delay_s,
                              no_retry_on=NO_RETRY, label=RETRY_LABEL,
                              sleep=self._sleep)
        except SpgemmError as e:
            if took_fast:
                breaker.record_failure()  # a raising fast path counts too
            for p in items:
                self._finish(p, error=e, backend=backend,
                             group_size=len(items))
            return
        except Exception as e:  # non-taxonomy leak: wrap typed, never bare
            err = KernelFallbackError(
                f"group dispatch failed outside the taxonomy: {e!r}")
            err.__cause__ = e
            if took_fast:
                breaker.record_failure()
            for p in items:
                self._finish(p, error=err, backend=backend,
                             group_size=len(items))
            return
        degraded = ex.kernel_source == "fallback"
        if degraded:
            self.counters["degraded_dispatches"] += 1
            if sp is not None:
                sp.set("fallback", ex.last_step)
        if took_fast:
            (breaker.record_failure if degraded
             else breaker.record_success)()
        for p, v in zip(items, vals):
            self._finish(p, value=ex.to_csr(v), backend=backend,
                         group_size=len(items), degraded=degraded)

    def step(self) -> int:
        """Pump one batch: shed expired requests, group up to ``max_batch``
        admitted ones by structure+dtype, one dispatch per group. Returns
        the number of responses resolved (completions + sheds)."""
        self.counters["steps"] += 1
        now = self.clock()
        resolved = 0
        # priority order, FIFO within a priority level
        self._queue.sort(key=lambda p: (-p.priority, p.seq))
        batch: list[_Pending] = []
        rest: list[_Pending] = []
        for p in self._queue:
            if p.deadline is not None and now > p.deadline:
                self._finish(p, error=DeadlineExceeded(
                    f"request {p.seq} deadline expired in queue "
                    f"({now - p.deadline:.4f}s past)"))
                self.counters["failed"] -= 1  # reclassify: shed, not failed
                self.counters["shed_deadline_expired"] += 1
                resolved += 1
            elif len(batch) < self.max_batch:
                batch.append(p)
            else:
                rest.append(p)
        self._queue = rest
        if not batch:  # the empty tick: dispatch nothing (cf. spgemm_grouped)
            return resolved
        t0 = self.clock()
        groups: OrderedDict[tuple, list[_Pending]] = OrderedDict()
        for p in batch:
            gkey = (p.skey, str(p.a.values.dtype), str(p.b.values.dtype))
            groups.setdefault(gkey, []).append(p)
        for items in groups.values():
            self._dispatch_group(items)
            resolved += len(items)
        step_s = self.clock() - t0
        self.metrics.observe("serve.step", step_s)
        return resolved

    def drain(self, max_steps: int | None = None) -> int:
        """Run ``step`` until the queue empties (or ``max_steps``); returns
        total responses resolved."""
        total = 0
        steps = 0
        while self._queue and (max_steps is None or steps < max_steps):
            total += self.step()
            steps += 1
        return total

    # ------------------------------------------------------------------
    # Warming + reporting
    # ------------------------------------------------------------------

    def warm(self, log: TrafficLog | None = None,
             limit: int | None = None) -> dict:
        """Prefetch plans for the hottest structures of ``log`` (default:
        the service's own traffic log) into the plan cache."""
        return warm_plan_cache(log or self.traffic_log, self.plan_cache,
                               limit=limit)

    def latency_percentiles(self, qs=(50.0, 99.0)) -> dict[str, float]:
        """{"p50": s, "p99": s, ...} over completed-request latencies (the
        ``serve.request`` histogram — log-bucketed, interpolated)."""
        h = self.metrics.histogram("serve.request")
        return {f"p{q:g}": h.percentile(q) for q in qs}

    def stats(self, debug: bool = False) -> dict:
        """Service counters + distributions (+ forensics with debug=True).

        ``step_latency`` / ``request_latency`` are real histogram summaries
        (count/mean/p50/p95/p99/min/max) — what replaced the old single
        EWMA; ``est_step_s`` is the admission estimator's current value.
        ``debug=True`` additionally dumps the flight recorder (the last-N
        dispatch events — kernels, fallback hops, errors) and the service's
        full metrics snapshot, the first thing to pull on a sick service.
        """
        from repro_torch.core.telemetry import RETRY_COUNTS

        total = self.counters["submitted"]
        shed = (self.counters["shed_queue_full"]
                + self.counters["shed_deadline_infeasible"]
                + self.counters["shed_deadline_expired"])
        out = {
            **self.counters,
            "queue_depth": len(self._queue),
            "executors": len(self._executors),
            "est_step_s": self._est_step_s(),
            "step_latency": self.metrics.histogram("serve.step").summary(),
            "request_latency":
                self.metrics.histogram("serve.request").summary(),
            "shed_rate": (shed / total) if total else 0.0,
            "plan_cache": self.plan_cache.stats(),
            "breakers": {n: b.snapshot() for n, b in self._breakers.items()},
            "retry": {
                "attempts": RETRY_COUNTS[f"{RETRY_LABEL}:attempt"],
                "retries": RETRY_COUNTS[f"{RETRY_LABEL}:retry"],
                "giveups": RETRY_COUNTS[f"{RETRY_LABEL}:giveup"],
            },
        }
        if debug:
            out["flight_recorder"] = obs_recorder.default_recorder().dump(
                reason="stats(debug=True)")
            out["metrics"] = self.metrics.snapshot()
        return out
