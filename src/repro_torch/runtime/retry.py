"""Bounded, jittered retry for replay/serving call sites.

A copy of ``repro/runtime/retry.py`` (stdlib only): the same schedule for
the same seed, and the same ``RETRY_COUNTS`` keys.

The serving-tier failure model (ROADMAP "The failure model") distinguishes
*transient* failures — a straggling device, an injected kernel fault, an
OSError from a liveness write — from *deterministic* ones: a corrupted
operand or a plan/operand mismatch will fail identically on every attempt,
so retrying it only burns the latency budget. ``retry_call`` encodes that
split: typed validation errors (``SpgemmInputError``, ``PlanMismatchError``
by default) re-raise immediately; everything else retries under jittered
exponential backoff until the bound, then gives up with a typed
``RetryExhaustedError`` carrying the attempt count and last error.

Determinism: jitter comes from ``random.Random(seed)``, not global state,
so a chaos run's retry schedule replays exactly. ``sleep=`` is injectable
so tests assert the schedule without real waiting.
"""
from __future__ import annotations

import random
import time
from typing import Callable

from repro_torch.runtime.validate import (PlanMismatchError, SpgemmError,
                                    SpgemmInputError)


class RetryExhaustedError(SpgemmError, RuntimeError):
    """All retry attempts failed; ``last_error`` / ``__cause__`` carry the
    final failure and ``attempts`` how many times the call ran."""

    def __init__(self, msg: str, attempts: int, last_error: BaseException):
        super().__init__(msg)
        self.attempts = attempts
        self.last_error = last_error


def backoff_schedule(retries: int, *, base_delay_s: float = 0.05,
                     max_delay_s: float = 2.0, jitter: float = 0.5,
                     seed: int = 0) -> list[float]:
    """The deterministic delay sequence ``retry_call`` would sleep.

    delay(i) = min(base * 2**i, max) * (1 + U[-jitter, +jitter]); exposed
    separately so tests and capacity planning can inspect it.
    """
    rng = random.Random(seed)
    out = []
    for attempt in range(retries):
        d = min(base_delay_s * (2.0 ** attempt), max_delay_s)
        out.append(d * (1.0 + rng.uniform(-jitter, jitter)))
    return out


def retry_call(fn: Callable, *args,
               retries: int = 3,
               base_delay_s: float = 0.05,
               max_delay_s: float = 2.0,
               jitter: float = 0.5,
               retry_on: tuple = (Exception,),
               no_retry_on: tuple = (SpgemmInputError, PlanMismatchError),
               seed: int = 0,
               sleep: Callable[[float], None] = time.sleep,
               on_retry: Callable | None = None,
               label: str | None = None,
               **kwargs):
    """Call ``fn(*args, **kwargs)``; retry transient failures up to
    ``retries`` extra attempts with jittered exponential backoff.

    ``no_retry_on`` wins over ``retry_on``: deterministic typed input/plan
    errors propagate on the first attempt. ``on_retry(attempt, exc, delay)``
    is invoked before each backoff sleep (telemetry hook). Raises
    ``RetryExhaustedError`` from the last failure once the bound is hit.

    Every attempt, every taken backoff, and every give-up is recorded in
    ``telemetry.RETRY_COUNTS`` keyed by ``label`` (default: the callable's
    ``__name__``), so serving loops can report retry rates without wrapping
    the hook: ``"<label>:attempt"`` / ``"<label>:retry"`` /
    ``"<label>:giveup"``.
    """
    from repro_torch.core.telemetry import RETRY_COUNTS  # lazy: telemetry is core

    if retries < 0:
        from repro_torch.runtime.validate import SpgemmConfigError  # cycle-free
        raise SpgemmConfigError(f"retries must be >= 0, got {retries}")
    if label is None:
        label = getattr(fn, "__name__", "anon")
    delays = backoff_schedule(retries, base_delay_s=base_delay_s,
                              max_delay_s=max_delay_s, jitter=jitter,
                              seed=seed)
    last: BaseException | None = None
    for attempt in range(retries + 1):
        try:
            RETRY_COUNTS[f"{label}:attempt"] += 1
            return fn(*args, **kwargs)
        except no_retry_on:
            raise
        except retry_on as e:
            last = e
            if attempt >= retries:
                break
            RETRY_COUNTS[f"{label}:retry"] += 1
            delay = delays[attempt]
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
    RETRY_COUNTS[f"{label}:giveup"] += 1
    err = RetryExhaustedError(
        f"gave up after {retries + 1} attempts: {last!r}",
        attempts=retries + 1, last_error=last)
    from repro_torch.obs import recorder, trace  # lazy: give-up path only

    recorder.note_error(err, site="retry", label=label,
                        attempts=retries + 1,
                        trace_id=trace.current_trace_id())
    raise err from last
