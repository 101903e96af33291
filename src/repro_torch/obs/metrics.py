"""Unified metrics registry: log-bucketed histograms + gauges + counters.

A copy of ``repro/obs/metrics.py`` (stdlib only), bound to the port's
``core.telemetry`` counters. Histogram buckets, percentiles and both
exporters are the reference's, so the two give equal quantiles on equal
samples.

One registry answers three kinds of question the counters alone could not:

  * **Distributions** — ``Histogram`` buckets latencies on a base-2 log scale
    (1us .. ~18h) and reports p50/p95/p99 by in-bucket interpolation, clamped
    to the exact observed min/max so tails are never invented. This replaces
    the serving tier's lone EWMA: ``SparseService`` keeps real step- and
    request-latency distributions, and ``obs.trace`` spans feed per-phase /
    per-kernel histograms (``plan.build``, ``numeric.dispatch``,
    ``numeric.dispatch[pallas]``, ...).
  * **Gauges** — live values read at export time (a plain number or a
    zero-arg callable), e.g. ``Heartbeat.write_errors`` surfaced mid-run
    instead of only at ``stop()``.
  * **Counters** — the nine existing ``core.telemetry`` counters join the
    same registry view (live references, not copies), so one exporter call
    captures the whole instrumentation surface.

Exporters: ``to_jsonl()`` (one JSON object per line — the archival format)
and ``to_prometheus()`` (text exposition format, names sanitized to
``repro_*``) — both pure renderings, no side effects on the metrics.

Histogram observation is only ever driven from code that already decided to
measure (an enabled span, the serving tier's step loop), so the registry
adds nothing to the tracing-off replay hot path.
"""
from __future__ import annotations

import bisect
import json
import math
import re
from typing import Any, Callable

# Base-2 log bucket upper bounds, in seconds: 1us * 2^i. 36 buckets reach
# ~19h; one underflow bucket below 1us and one overflow bucket above the top.
_BUCKET_BOUNDS: list[float] = [1e-6 * (2.0 ** i) for i in range(37)]


class Histogram:
    """Log-bucketed latency histogram with interpolated percentiles."""

    __slots__ = ("name", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.counts = [0] * (len(_BUCKET_BOUNDS) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(_BUCKET_BOUNDS, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float:
        """Interpolated q-th percentile (q in [0, 100]); NaN when empty.

        Linear interpolation inside the owning bucket, clamped to the exact
        observed [min, max] — a single observation reports itself exactly,
        and all-zero latencies (injected test clocks) report 0, not 1us.
        """
        if self.count == 0:
            return float("nan")
        rank = (q / 100.0) * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = 0.0 if i == 0 else _BUCKET_BOUNDS[i - 1]
                hi = (_BUCKET_BOUNDS[i] if i < len(_BUCKET_BOUNDS)
                      else max(self.max, lo))
                frac = (rank - seen) / c
                est = lo + (hi - lo) * frac
                return float(min(max(est, self.min), self.max))
            seen += c
        return float(self.max)

    def summary(self) -> dict:
        """{count, sum, mean, p50, p95, p99, min, max} — the JSONL row body."""
        empty = self.count == 0
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": (self.sum / self.count) if not empty else float("nan"),
            "p50": self.percentile(50.0),
            "p95": self.percentile(95.0),
            "p99": self.percentile(99.0),
            "min": self.min if not empty else float("nan"),
            "max": self.max if not empty else float("nan"),
        }


class Gauge:
    """A live value: a number set with ``set()`` or a zero-arg callable
    (read at export time — the liveness is the point)."""

    __slots__ = ("name", "_value", "_fn")

    def __init__(self, name: str, fn: Callable[[], float] | None = None):
        self.name = name
        self._value = 0.0
        self._fn = fn

    def set(self, value: float) -> None:
        self._fn = None
        self._value = float(value)

    def read(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        return self._value


def _prom_name(name: str) -> str:
    return "repro_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


class MetricsRegistry:
    """Histograms + gauges + the telemetry counters, one export surface."""

    def __init__(self, name: str = "default"):
        self.name = name
        self._hists: dict[str, Histogram] = {}
        self._gauges: dict[str, Gauge] = {}

    # -- recording -----------------------------------------------------

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(name)
        return h

    def observe(self, name: str, seconds: float) -> None:
        self.histogram(name).observe(seconds)

    def gauge(self, name: str,
              fn: Callable[[], float] | None = None) -> Gauge:
        """Get-or-create a gauge; ``fn`` (re)binds a live read callback."""
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, fn)
        elif fn is not None:
            g._fn = fn
        return g

    def set_gauge(self, name: str, value: float) -> None:
        self.gauge(name).set(value)

    # -- views ---------------------------------------------------------

    def counters(self) -> dict[str, dict[str, int]]:
        """Plain-dict copy of the nine ``core.telemetry`` counters."""
        from repro_torch.core import telemetry  # lazy: telemetry imports core

        return telemetry.snapshot()

    def snapshot(self) -> dict:
        return {
            "counters": self.counters(),
            "histograms": {n: h.summary()
                           for n, h in sorted(self._hists.items())},
            "gauges": {n: g.read() for n, g in sorted(self._gauges.items())},
        }

    # -- exporters -----------------------------------------------------

    def to_jsonl(self) -> str:
        """One JSON object per line: counters, histogram summaries, gauges."""
        lines = []
        for group, keys in sorted(self.counters().items()):
            for key, value in sorted(keys.items()):
                lines.append(json.dumps(
                    {"type": "counter", "group": group, "key": key,
                     "value": value}))
        for name, h in sorted(self._hists.items()):
            lines.append(json.dumps(
                {"type": "histogram", "name": name, **h.summary()}))
        for name, g in sorted(self._gauges.items()):
            lines.append(json.dumps(
                {"type": "gauge", "name": name, "value": g.read()}))
        return "\n".join(lines)

    def to_prometheus(self) -> str:
        """Prometheus text exposition: counters as ``repro_<group>_total``
        (labelled by key), histograms as summary quantiles + _count/_sum,
        gauges as plain gauges."""
        out = []
        for group, keys in sorted(self.counters().items()):
            pname = _prom_name(group) + "_total"
            out.append(f"# TYPE {pname} counter")
            for key, value in sorted(keys.items()):
                out.append(f'{pname}{{key="{key}"}} {value}')
        for name, h in sorted(self._hists.items()):
            pname = _prom_name(name) + "_seconds"
            s = h.summary()
            out.append(f"# TYPE {pname} summary")
            for q, label in ((50.0, "0.5"), (95.0, "0.95"), (99.0, "0.99")):
                out.append(
                    f'{pname}{{quantile="{label}"}} {h.percentile(q):.9g}')
            out.append(f"{pname}_sum {s['sum']:.9g}")
            out.append(f"{pname}_count {s['count']}")
        for name, g in sorted(self._gauges.items()):
            pname = _prom_name(name)
            out.append(f"# TYPE {pname} gauge")
            out.append(f"{pname} {g.read():.9g}")
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        self._hists.clear()
        self._gauges.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry spans and gauges feed by default."""
    return _DEFAULT


def observe(name: str, seconds: float) -> None:
    """Record one latency into the default registry's ``name`` histogram."""
    _DEFAULT.observe(name, seconds)


def reset_metrics() -> None:
    """Clear the default registry (tests)."""
    _DEFAULT.reset()
