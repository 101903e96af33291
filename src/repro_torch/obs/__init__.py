"""repro_torch.obs — phase-level tracing, latency histograms, flight recorder.

Three coordinated pieces (see each module's docstring for the full story):

  * :mod:`repro_torch.obs.trace` — ``span()`` phase tracing with Chrome trace-event
    export, trace-ID propagation and a ``$REPRO_TRACE`` env default;
  * :mod:`repro_torch.obs.metrics` — log-bucketed latency histograms, live gauges
    and the nine telemetry counters behind one registry with JSONL /
    Prometheus exporters;
  * :mod:`repro_torch.obs.recorder` — a bounded flight-recorder ring of the last-N
    dispatch events, dumped automatically on kernel/retry give-up.

The contract that makes this safe to thread through the hot path: with
tracing off (the default), a ``span()`` call is one mode check returning a
shared no-op — the pinned-replay path stays dispatch-identical, which
tests/test_torch_obs.py asserts via telemetry. Stdlib only, apart from
``torch.profiler`` in the trace mode "xprof".
"""
from repro_torch.obs.metrics import (
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    observe,
    reset_metrics,
)
from repro_torch.obs.recorder import (
    FlightRecorder,
    default_recorder,
    reset_recorder,
)
from repro_torch.obs.trace import (
    TRACE_ENV_VAR,
    TRACE_MODES,
    clear,
    current_trace_id,
    enabled,
    events,
    export_chrome_trace,
    new_trace_id,
    reset_tracing,
    resolve_trace_mode,
    set_tracing,
    span,
    trace_context,
    trace_scope,
)


def reset_obs() -> None:
    """Reset the whole observability layer (tests): tracing state + event
    buffer, the default metrics registry, and the flight-recorder ring."""
    reset_tracing()
    reset_metrics()
    reset_recorder()


__all__ = [
    "TRACE_ENV_VAR",
    "TRACE_MODES",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "clear",
    "current_trace_id",
    "default_recorder",
    "default_registry",
    "enabled",
    "events",
    "export_chrome_trace",
    "new_trace_id",
    "observe",
    "reset_metrics",
    "reset_obs",
    "reset_recorder",
    "reset_tracing",
    "resolve_trace_mode",
    "set_tracing",
    "span",
    "trace_context",
    "trace_scope",
]
