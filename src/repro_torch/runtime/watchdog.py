"""Fault-tolerance runtime: heartbeats + straggler watchdog.

A copy of ``repro/runtime/watchdog.py`` (stdlib only). The executor that
wraps a replay in ``StepWatchdog.step`` synchronises the card inside the
step for CUDA operands, so the deadline covers the finished result.

On a 1000+-node cluster the failure model is: (a) hard node loss — the
runner reschedules, the trainer resumes from the latest atomic checkpoint
with exact data skip-ahead; (b) stragglers — a step exceeding the deadline
flags the node; the policy (checkpoint-and-requeue) avoids dragging the
whole synchronous step at the slowest node's pace.

These are host-side utilities (no device code): ``Heartbeat`` writes a
liveness file the cluster runner monitors; ``StepWatchdog`` wraps each step
(training steps in ``launch/train.py``, pinned-plan replays via
``ReuseExecutor(watchdog=...)``) and triggers the straggler policy.
Deadline math uses ``time.monotonic()`` — wall-clock jumps (NTP slew,
suspend/resume) must not fire or mask a deadline.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time


class Heartbeat:
    """Background thread writing {step, time} to a liveness file.

    Write failures (disk full, unlinked directory) must not kill the beat:
    the whole point of a liveness file is surviving a degraded node long
    enough to report it. Each failed write is counted on ``write_errors``
    and the thread keeps beating; ``stop()`` returns the final count so the
    caller can surface persistent failures.
    """

    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval_s = interval_s
        self.step = 0
        self.write_errors = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        # Live visibility: a dying disk should show up in a metrics
        # scrape mid-run, not only at stop(). The gauge reads the counter
        # through a callback, so every export sees the current value.
        from repro_torch.obs import metrics  # lazy: keep runtime import-light

        metrics.default_registry().gauge(
            "heartbeat.write_errors", fn=lambda: self.write_errors)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            tmp = self.path + ".tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump({"step": self.step, "time": time.time()}, f)
                os.replace(tmp, self.path)
            except OSError:
                self.write_errors += 1
            self._stop.wait(self.interval_s)

    def stop(self) -> int:
        """Stop the beat; returns the number of failed liveness writes."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2 * self.interval_s)
        return self.write_errors


class StragglerDetected(RuntimeError):
    pass


class StepWatchdog:
    """Flags steps that exceed a deadline (straggler mitigation hook).

    policy="raise"  -> raise StragglerDetected (caller checkpoints + exits
                       for reschedule; the default requeue-style policy)
    policy="warn"   -> print and continue (collect telemetry)

    A step body that raises is still timed and recorded in ``slow_steps``
    (the body's exception propagates — a slow *failing* step must not be
    masked by a second exception from the watchdog, so ``policy="raise"``
    only fires when the body completed).
    """

    def __init__(self, deadline_s: float = 300.0, policy: str = "warn"):
        self.deadline_s = deadline_s
        self.policy = policy
        self.slow_steps: list[tuple[int, float]] = []

    @contextlib.contextmanager
    def step(self, step_idx: int):
        t0 = time.monotonic()
        ok = False
        try:
            yield
            ok = True
        finally:
            dt = time.monotonic() - t0
            if dt > self.deadline_s:
                self.slow_steps.append((step_idx, dt))
                msg = (f"step {step_idx} took {dt:.1f}s "
                       f"(deadline {self.deadline_s:.1f}s)")
                if self.policy == "raise" and ok:
                    raise StragglerDetected(msg)
                print("WATCHDOG:", msg)
