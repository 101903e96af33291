"""Per-kernel circuit breaker for the serving tier's fast replay path (port
of ``repro/serve/breaker.py``, pure Python: the same state machine, the same
``BREAKER_COUNTS`` keys, from ``repro_torch.core.telemetry``).

The degradation ladder already guarantees *correctness* under kernel
failure: a faulting replay kernel re-dispatches the next rung (on the CPU the
plain replay, as in the reference; on the card the other replay kernel),
counted in ``telemetry.FALLBACK_COUNTS``. What it does not bound is *cost*:
under sustained traffic a persistently broken kernel makes every request pay
a failed dispatch before landing on the safe path. The breaker closes that
gap with the classic three-state machine:

  closed     — normal operation, traffic takes the fast kernel. Failures
               (ladder fallbacks, i.e. ``fault:*`` events) are timestamped;
               ``failure_threshold`` of them inside ``window_s`` opens.
  open       — traffic is routed straight to the recorded-safe path
               (``allow()`` returns False; each refusal is counted as a
               ``short_circuit``). After ``cooldown_s`` the breaker arms a
               probe and moves to half-open.
  half-open  — exactly ONE request is let through on the fast kernel (the
               probe). Success closes the breaker (fast path re-admitted for
               everyone); failure re-opens it for another cooldown.

Every transition is recorded in ``telemetry.BREAKER_COUNTS`` keyed
``"<name>:<event>"`` (open / half_open / close / reopen / short_circuit), so
``chip_smoke.py`` and the chaos tests can assert breaker behavior without
poking at instance state.

Determinism: the clock is injectable (``clock=``, default
``time.monotonic``), so tests and replay harnesses drive cooldowns with a
fake clock instead of sleeping. The breaker is intentionally host-side-only
state — it never touches device dispatch itself; the service consults
``allow()`` and reports outcomes via ``record_success``/``record_failure``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable

from repro_torch.runtime.validate import SpgemmConfigError

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Failure-rate gate over one named fast path (usually a kernel).

    failure_threshold: failures within ``window_s`` that trip the breaker.
    window_s:          sliding window the threshold is evaluated over.
    cooldown_s:        open -> half-open delay before the next probe.
    """

    def __init__(self, name: str, *, failure_threshold: int = 3,
                 window_s: float = 30.0, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise SpgemmConfigError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        if window_s <= 0 or cooldown_s < 0:
            raise SpgemmConfigError(
                f"window_s must be > 0 and cooldown_s >= 0, got "
                f"window_s={window_s}, cooldown_s={cooldown_s}")
        self.name = name
        self.failure_threshold = failure_threshold
        self.window_s = window_s
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.state = CLOSED
        self._failures: deque[float] = deque()
        self._opened_at: float | None = None
        self._probe_in_flight = False

    def _count(self, event: str) -> None:
        from repro_torch.core.telemetry import BREAKER_COUNTS  # lazy: cycle-free

        BREAKER_COUNTS[f"{self.name}:{event}"] += 1

    def _prune(self, now: float) -> None:
        while self._failures and now - self._failures[0] > self.window_s:
            self._failures.popleft()

    def allow(self) -> bool:
        """May the next dispatch take the fast path?

        False means "route to the safe kernel" and is counted as a
        short_circuit — the caller must not silently drop the request.
        In half-open, True is handed out to exactly one caller at a time
        (the probe); everyone else short-circuits until its verdict lands.
        """
        now = self.clock()
        if self.state == OPEN:
            if now - self._opened_at >= self.cooldown_s:
                self.state = HALF_OPEN
                self._probe_in_flight = False
                self._count("half_open")
            else:
                self._count("short_circuit")
                return False
        if self.state == HALF_OPEN:
            if self._probe_in_flight:
                self._count("short_circuit")
                return False
            self._probe_in_flight = True
            return True
        return True

    def record_success(self) -> None:
        """A fast-path dispatch completed without degrading."""
        if self.state == HALF_OPEN:
            self.state = CLOSED
            self._failures.clear()
            self._probe_in_flight = False
            self._count("close")

    def record_failure(self) -> None:
        """A fast-path dispatch degraded (ladder fallback) or raised."""
        now = self.clock()
        if self.state == HALF_OPEN:
            # the probe failed: straight back to open, new cooldown
            self.state = OPEN
            self._opened_at = now
            self._probe_in_flight = False
            self._count("reopen")
            return
        self._failures.append(now)
        self._prune(now)
        if self.state == CLOSED and len(self._failures) >= self.failure_threshold:
            self.state = OPEN
            self._opened_at = now
            self._count("open")

    def snapshot(self) -> dict:
        """Host-side state for stats()/bench rows (no telemetry reads)."""
        now = self.clock()
        self._prune(now)
        return {
            "name": self.name,
            "state": self.state,
            "recent_failures": len(self._failures),
            "failure_threshold": self.failure_threshold,
            "cooldown_remaining_s": (
                max(0.0, self.cooldown_s - (now - self._opened_at))
                if self.state == OPEN else 0.0),
        }
