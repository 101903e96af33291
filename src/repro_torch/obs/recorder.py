"""Flight recorder: a bounded ring of the last-N dispatch events.

A copy of ``repro/obs/recorder.py`` (stdlib only).

When a replay fails in production the question is never "did it fail" (the
typed taxonomy answers that) but "what was the stack doing just before":
which kernels dispatched, on which structures, how long they took, and which
ladder hops already happened. The recorder keeps exactly that — a
``deque(maxlen=N)`` of dispatch events — and dumps it at the moments the
failure model defines:

  * automatically when a ``KernelFallbackError`` is raised (executor /
    kernel-ladder give-up) or a ``RetryExhaustedError`` fires (the serving
    tier's retry bound) — ``note_error`` snapshots the ring into
    ``last_dump`` and prints a one-line notice to stderr;
  * on demand via ``SparseService.stats(debug=True)`` or ``dump()``.

Recording policy mirrors the tracing-off contract: *successful* dispatches
are recorded only while tracing is enabled (the hot path stays untouched);
*fallback hops and errors* are always recorded — they are rare, already off
the fast path, and exactly what the ring exists to remember.
"""
from __future__ import annotations

import sys
import time
from collections import deque

DEFAULT_CAPACITY = 256


class FlightRecorder:
    """Bounded ring of dispatch events (plain dicts, host-side only)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            from repro_torch.runtime.validate import SpgemmConfigError  # cycle-free
            raise SpgemmConfigError(
                f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._seq = 0
        self.last_dump: dict | None = None

    def record(self, event: str, **fields) -> dict:
        """Append one event (oldest entry falls off past ``capacity``).

        Conventional fields: ``kernel``, ``structure_key``, ``shapes``,
        ``duration_s``, ``verdict`` ("ok" | "fallback" | "error"),
        ``fallback`` ("<from>-><to>" hop), ``trace_id``, ``site``.
        """
        self._seq += 1
        entry = {"seq": self._seq, "event": event,
                 "wall_time": time.time(), **fields}
        self._ring.append(entry)
        return entry

    def events(self) -> list[dict]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def dump(self, reason: str) -> dict:
        """Snapshot the ring: {reason, recorded (lifetime), events}."""
        return {"reason": reason, "recorded": self._seq,
                "capacity": self.capacity, "events": self.events()}

    def note_error(self, exc: BaseException, **context) -> dict:
        """The automatic-dump hook: record the error event, snapshot the
        ring into ``last_dump``, announce on stderr. Returns the dump."""
        self.record("error", verdict="error",
                    error=f"{type(exc).__name__}: {exc}", **context)
        self.last_dump = self.dump(
            reason=f"{type(exc).__name__}: {exc}")
        print(f"FLIGHT-RECORDER: dumped {len(self._ring)} events after "
              f"{type(exc).__name__}", file=sys.stderr)
        return self.last_dump

    def reset(self) -> None:
        self._ring.clear()
        self._seq = 0
        self.last_dump = None


_DEFAULT = FlightRecorder()


def default_recorder() -> FlightRecorder:
    """The process-wide ring the executor / kernel ladder / retry feed."""
    return _DEFAULT


def record(event: str, **fields) -> dict:
    return _DEFAULT.record(event, **fields)


def note_error(exc: BaseException, **context) -> dict:
    return _DEFAULT.note_error(exc, **context)


def reset_recorder() -> None:
    """Clear the default ring (tests)."""
    _DEFAULT.reset()
