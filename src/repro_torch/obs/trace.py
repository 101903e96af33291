"""Phase-level tracing: near-zero-overhead-when-off spans + Chrome export.

Port of ``repro/obs/trace.py`` (stdlib only, plus ``torch.profiler`` in
the "xprof" mode): the same modes, event ring and Chrome export, and the
reference's span names plus two of the port's own (``plan.hash``,
``host.read``). "xprof" wraps every span in
``torch.profiler.record_function``, so the phases appear as user
annotations in a ``torch.profiler`` trace beside the kernels they launched.

The repo's nine telemetry counters answer "how many times did X happen";
nothing answered "where did the time go inside one call" — expand vs sort vs
plan-build vs numeric dispatch is exactly the attribution the paper's
reuse-vs-rebuild argument needs (Kokkos Kernels' own SpGEMM work leans on a
per-phase timer hierarchy for the same reason). This module is that layer:

  * ``with span("plan.build"): ...`` — a nesting span API instrumenting the
    phases of ``core/spgemm.py``, ``core/executor.py``, ``dist/executor.py``,
    ``kernels/ops.py`` and ``serve/spgemm_service.py``.
  * **Off by default, and off means OFF**: a disabled ``span()`` returns a
    shared no-op context manager — no event, no timestamp, no histogram
    observation, no counter bump — so the pinned-replay hot path stays
    dispatch-identical to the untraced build (telemetry-asserted in
    tests/test_obs.py; priced in ``benchmarks.run --bench obs``).
  * Modes mirror ``$REPRO_VALIDATE``: ``spgemm(trace=...)`` takes
    ``None | bool | "off" | "on" | "xprof"``; ``None`` defers to the
    ``$REPRO_TRACE`` environment variable (else "off"). "xprof" additionally
    wraps every span in ``torch.profiler.record_function`` so the phases land
    inside ``torch.profiler`` traces.
  * **Trace-ID propagation**: ``trace_context(tid)`` sets the ambient request
    id; every span records it, so a ``SparseService`` request's id travels
    from admission through grouping, ``resolve_plan``, executor dispatch and
    the retry/breaker path into the exported trace.
  * ``export_chrome_trace(path)`` writes Chrome trace-event JSON ("X"
    complete events) loadable in chrome://tracing / Perfetto. Its ``ts`` is
    on the Unix-epoch clock in us, the clock of ``torch.profiler``'s
    events, so an export of an "on" run lays over a profiler trace of it.
  * ``span("host.read", site=...)`` wraps one device->host read on the
    sparse path (``int()`` of a tensor, ``.tolist()``, ``.cpu()``, ...), so
    that a profiler trace puts the device's idle time there down to it.

Completed spans also feed ``obs.metrics`` latency histograms keyed by span
name (plus a ``<name>[<kernel>]`` variant when the span carries a ``kernel``
attr), which is where the per-phase / per-kernel p50/p95/p99 distributions
come from. Spans time the *host side* of a dispatch — CUDA's asynchronous
launches are never waited on; device time belongs to the "xprof" mode's
annotations.

Single-threaded by design, like the serving tier: the span stack and the
ambient trace id are plain module state, deterministic under the chaos
suite's injected clocks.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any

TRACE_MODES = ("off", "on", "xprof")

# Environment override consulted when the mode is unset / trace=None: mirrors
# $REPRO_VALIDATE so obs CI can force tracing across a run without touching
# call sites.
TRACE_ENV_VAR = "REPRO_TRACE"

# Bound on buffered span events: a runaway traced loop must degrade to
# dropped events (counted), never to unbounded host memory.
MAX_EVENTS = 100_000

# The span taxonomy. Every ``span("...")`` literal in the stack must come
# from this set — dashboards, the flight recorder, the latency histograms
# and the ROADMAP phase table all key on these exact strings, so a
# free-typed name silently drops out of the phase-latency story. Enforced
# statically by ``python -m repro.analysis`` (rule ``span``); extend the
# set (and the ROADMAP table) in the same commit that adds a new phase.
SPAN_NAMES = frozenset({
    "spgemm.prepare",     # operand normalization: repad, flop count
    "spgemm.symbolic",    # symbolic phase: sizes + plan expansion
    "plan.build",         # plan assembly (sort, seg ids, slot maps)
    "numeric.dispatch",   # executor-level replay dispatch
    "numeric.kernel",     # one numeric kernel execution
    "dist.replay",        # sharded replay (the port's dist/ slice)
    "serve.admit",        # serving-tier admission decision
    "serve.dispatch",     # serving-tier batch dispatch
    # the port's own, beyond the reference's taxonomy
    "plan.hash",          # structure_key: host copies + digest, every caller
    "host.read",          # one device->host read; site="<function>.<what>"
})


def resolve_trace_mode(mode: str | bool | None) -> str:
    """Normalize a ``trace=`` argument to a concrete mode.

    ``None`` defers to ``$REPRO_TRACE`` (else "off"); booleans map to
    "on"/"off"; anything outside ``TRACE_MODES`` is a loud
    ``SpgemmConfigError`` (a typo'd mode silently tracing nothing would
    defeat the layer).
    """
    from repro_torch.runtime.validate import SpgemmConfigError  # cycle-free

    if mode is None:
        raw = os.environ.get(TRACE_ENV_VAR, "off") or "off"
        lowered = raw.strip().lower()
        aliases = {"": "off", "0": "off", "false": "off", "off": "off",
                   "1": "on", "true": "on", "on": "on", "xprof": "xprof"}
        if lowered not in aliases:
            raise SpgemmConfigError(
                f"unknown ${TRACE_ENV_VAR} value {raw!r}; expected one of "
                f"{TRACE_MODES} (or 0/1/true/false)")
        return aliases[lowered]
    if mode is True:
        return "on"
    if mode is False:
        return "off"
    if mode not in TRACE_MODES:
        raise SpgemmConfigError(
            f"unknown trace mode {mode!r}; expected one of {TRACE_MODES} "
            f"(or True/False/None)")
    return mode


class _TraceState:
    """Module-global tracer state (single-threaded, reset per test)."""

    __slots__ = ("mode", "events", "depth", "trace_id", "t0", "t0_epoch_ns",
                 "dropped", "next_id")

    def __init__(self):
        self.mode: str | None = None  # None = resolve $REPRO_TRACE lazily
        self.events: list[dict] = []
        self.depth: int = 0
        self.trace_id: str | None = None
        self.t0: float = time.perf_counter()
        self.t0_epoch_ns: int = time.time_ns()  # the Unix-epoch time of t0
        self.dropped: int = 0
        self.next_id: int = 0


_STATE = _TraceState()


def _mode() -> str:
    m = _STATE.mode
    if m is None:
        m = resolve_trace_mode(None)
        _STATE.mode = m
    return m


def enabled() -> bool:
    """True when spans record (mode "on"/"xprof"). The hot-path check."""
    return _mode() != "off"


def set_tracing(mode: str | bool | None) -> str:
    """Set the global trace mode; ``None`` re-defers to ``$REPRO_TRACE``.
    Returns the concrete mode now in effect."""
    _STATE.mode = None if mode is None else resolve_trace_mode(mode)
    return _mode()


def new_trace_id(prefix: str = "trace") -> str:
    """A fresh process-unique trace id (counter-based, deterministic)."""
    _STATE.next_id += 1
    return f"{prefix}-{_STATE.next_id}"


def current_trace_id() -> str | None:
    """The ambient request trace id set by ``trace_context`` (None outside)."""
    return _STATE.trace_id


class _Noop:
    """The disabled path: one shared instance, every method a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key: str, value: Any) -> None:
        pass


_NOOP = _Noop()


class _Span:
    """One live span: records a Chrome "X" event + a histogram observation on
    exit. Only ever constructed when tracing is enabled."""

    __slots__ = ("name", "attrs", "_start", "_annotation")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._start = 0.0
        self._annotation = None

    def set(self, key: str, value: Any) -> None:
        """Attach an attribute discovered mid-span (e.g. a resolved method)."""
        self.attrs[key] = value

    def __enter__(self):
        if _mode() == "xprof":
            try:
                from torch.profiler import record_function

                self._annotation = record_function(self.name)
                self._annotation.__enter__()
            # observability must never fail the observed call: a missing or
            # broken profiler hook degrades to "no annotation", by design
            # repro: allow[taxonomy] intentional silent degradation
            except Exception:
                self._annotation = None  # profiling must never fail the call
        _STATE.depth += 1
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter()
        _STATE.depth -= 1
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        dur_s = end - self._start
        args = dict(self.attrs)
        tid = _STATE.trace_id
        if tid is not None and "trace_id" not in args:
            args["trace_id"] = tid
        if exc_type is not None:
            args["error"] = exc_type.__name__
        if len(_STATE.events) < MAX_EVENTS:
            _STATE.events.append({
                "name": self.name,
                "ts": (self._start - _STATE.t0) * 1e6,  # Chrome wants us
                "dur": dur_s * 1e6,
                "depth": _STATE.depth,
                "args": args,
            })
        else:
            _STATE.dropped += 1
        from repro_torch.obs import metrics  # lazy: metrics pulls telemetry

        metrics.observe(self.name, dur_s)
        kernel = self.attrs.get("kernel")
        if kernel is not None:
            metrics.observe(f"{self.name}[{kernel}]", dur_s)
        return False


def span(name: str, **attrs):
    """Open a phase span: ``with span("plan.build", fm_cap=cap): ...``.

    Disabled tracing returns a shared no-op context manager — the call costs
    one mode check and nothing else (no event, no clock read, no histogram).
    Attrs land in the exported event's ``args``; a ``kernel=`` attr
    additionally routes the duration into that kernel's histogram.
    """
    if not enabled():
        return _NOOP
    return _Span(name, attrs)


class _TraceContext:
    __slots__ = ("tid", "prev")

    def __init__(self, tid: str | None):
        self.tid = tid
        self.prev = None

    def __enter__(self):
        self.prev = _STATE.trace_id
        _STATE.trace_id = self.tid
        return self

    def __exit__(self, *exc):
        _STATE.trace_id = self.prev
        return False


def trace_context(trace_id: str | None):
    """Set the ambient request trace id for the enclosed spans.

    The propagation mechanism: ``SparseService`` enters this around each
    group dispatch, so the nested ``plan.build`` / ``numeric.dispatch`` /
    retry spans all carry the request's id end-to-end. No-op when tracing is
    off (the id would have nowhere to land).
    """
    if not enabled():
        return _NOOP
    return _TraceContext(trace_id)


class _TraceScope:
    __slots__ = ("mode", "prev")

    def __init__(self, mode: str):
        self.mode = mode
        self.prev = None

    def __enter__(self):
        self.prev = _STATE.mode
        _STATE.mode = self.mode
        return self

    def __exit__(self, *exc):
        _STATE.mode = self.prev
        return False


def trace_scope(mode: str | bool | None):
    """Temporarily override the trace mode for one call.

    The mechanism behind ``spgemm(trace=...)``: ``None`` is a no-op (the
    ambient mode — ultimately ``$REPRO_TRACE`` — stays in charge), anything
    else pins the mode for the scope's duration and restores on exit.
    """
    if mode is None:
        return _NOOP
    return _TraceScope(resolve_trace_mode(mode))


def events() -> list[dict]:
    """The buffered span events (raw internal form; see export_chrome_trace)."""
    return list(_STATE.events)


def clear() -> None:
    """Drop buffered events and reset the clock origin (mode unchanged)."""
    _STATE.events.clear()
    _STATE.dropped = 0
    _STATE.t0_epoch_ns = time.time_ns()
    _STATE.t0 = time.perf_counter()


def export_chrome_trace(path: str | None = None) -> dict:
    """Render buffered spans as Chrome trace-event JSON.

    Returns the payload (``{"traceEvents": [...complete "X" events...]}``);
    when ``path`` is given, also writes it there. Load the file in
    chrome://tracing or https://ui.perfetto.dev. Span attrs (including the
    propagated ``trace_id``) are in each event's ``args``. ``ts`` is in us
    since the Unix epoch, as ``torch.profiler`` times its events: the
    origin read at ``clear()`` with both clocks, the spans timed on
    ``perf_counter``.
    """
    epoch_us = _STATE.t0_epoch_ns / 1e3
    trace_events = [
        {
            "name": ev["name"],
            "cat": "repro",
            "ph": "X",
            "ts": round(epoch_us + ev["ts"], 3),
            "dur": round(ev["dur"], 3),
            "pid": 1,
            "tid": 1,
            "args": ev["args"],
        }
        for ev in _STATE.events
    ]
    payload = {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {"dropped_events": _STATE.dropped},
    }
    if path is not None:
        with open(path, "w") as f:
            json.dump(payload, f)
    return payload


def reset_tracing() -> None:
    """Full reset (tests): mode back to lazy-$REPRO_TRACE, buffers cleared."""
    _STATE.mode = None
    _STATE.trace_id = None
    _STATE.depth = 0
    _STATE.next_id = 0
    clear()
