"""What a traced run reads from ``torch.profiler``: device busy time, device
time by operation, device time of the kernels launched inside a host span,
the time the host was held by the device or the profiler (``blocked_s``),
and the idle gaps of the device labelled by what the host was doing.

It reads the profiler's raw events (``kineto_results.events()``), which is
some twenty times faster than building ``FunctionEvent`` trees: a window of
replays holds hundreds of thousands of events. A kernel is tied to the host
operation that launched it by the profiler's correlation ids, so a kernel
belongs to a span when its launch lies inside the span on the host.

A trace recorded with the CUDA activity alone has no host operations or
spans, only the device's events and the CUDA runtime calls and overhead
events on the host; the window is then the whole trace.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_memcpy2d")
NAME_CHARS = 120  # kernel names are long templates: keep their head
# CUPTI's overhead events, by the names the profiler gives them
OVERHEAD_NAMES = frozenset({
    "Command Buffer Full", "Activity Buffer Request", "Buffer Flush", "Driver Compiler",
    "Instrumentation", "Resource", "Runtime Triggered Module Loading",
    "Lazy Function Loading", "Unknown"})


def is_runtime_call(name: str) -> bool:
    """A CUDA runtime (``cuda*``) or driver (``cu[A-Z]*``) call. Told by
    name: the card's torch does not mark it otherwise (runtime calls there
    carry correlation ids like the host operations)."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def _merge(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceData:
    """Events of one profiled window, times in ns on the profiler's clock.

    ``cpu``: (start, end, name, thread, correlation, linked, annotation);
    ``dev``: (start, end, name, linked correlation).
    The window is the host span ``window``, which the harness opens around
    its whole measured loop and the final synchronisation, or, where host
    spans were not recorded, the whole trace."""

    def __init__(self, cpu: list, dev: list, window: str = "bench.window"):
        wins = [e for e in cpu if e[6] and e[2] == window]
        if wins:
            w = max(wins, key=lambda e: e[1] - e[0])
            self.w0, self.w1 = w[0], w[1]
        else:
            ends = [(e[0], e[1]) for e in cpu] + [(e[0], e[1]) for e in dev]
            self.w0 = min((s for s, _ in ends), default=0)
            self.w1 = max((e for _, e in ends), default=0)
        self.dev = sorted((max(s, self.w0), min(e, self.w1), n, c) for s, e, n, c in dev
                          if e > self.w0 and s < self.w1)
        self.cpu = [e for e in cpu if e[1] > self.w0 and e[0] < self.w1]
        self._launch = {e[4]: e[0] for e in cpu if e[5] == 0 and e[4] != 0}
        self._spans: dict[str, list] = defaultdict(list)
        for e in self.cpu:
            if e[6]:
                self._spans[e[2]].append((e[0], e[1]))
        for v in self._spans.values():
            v.sort()

    @classmethod
    def from_profiler(cls, prof, window: str = "bench.window") -> "TraceData":
        """Read a finished ``torch.profiler.profile``. Device events are the
        kernels, copies and fills: the device's copies of host annotations
        are left out (torch builds without ``activity_type`` mark them only
        as annotations, and by their names)."""
        from torch.autograd import DeviceType

        cpu, dev = [], []
        for e in prof.profiler.kineto_results.events():
            kind = e.activity_type() if hasattr(e, "activity_type") else None
            annotation = e.is_user_annotation()
            if e.device_type() == DeviceType.CPU:
                cpu.append((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id(),
                            e.correlation_id(), e.linked_correlation_id(),
                            annotation and kind in (None, "user_annotation")))
            elif (kind in DEVICE_ACTIVITIES if kind is not None else not annotation):
                dev.append((e.start_ns(), e.end_ns(), e.name(), e.linked_correlation_id()))
        spans = {e[2] for e in cpu if e[6]}
        return cls(cpu, [d for d in dev if d[2] not in spans], window)

    def _merged(self) -> list:
        return _merge((s, e) for s, e, _, _ in self.dev)

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device."""
        return sum(e - s for s, e in self._merged()) * 1e-9

    @property
    def device_events(self) -> int:
        return len(self.dev)

    def device_ops(self) -> dict:
        """Device seconds by operation name (names cut to their head)."""
        out: dict = defaultdict(float)
        for s, e, n, _ in self.dev:
            out[n[:NAME_CHARS]] += (e - s) * 1e-9
        return dict(out)

    def kernel_s(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for s, e, n, _ in self.dev if match(n)) * 1e-9

    def kernel_names(self) -> set:
        return {n for _, _, n, _ in self.dev}

    @staticmethod
    def _inside(intervals: list, t: int) -> bool:
        i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
        return i >= 0 and intervals[i][0] <= t <= intervals[i][1]

    def span_count(self, name: str) -> int:
        return len(self._spans.get(name, ()))

    def span_device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside host spans
        ``name`` (a launch's host operation starts inside one)."""
        spans = self._spans.get(name, [])
        total = 0
        for s, e, _, corr in self.dev:
            t = self._launch.get(corr)
            if t is not None and self._inside(spans, t):
                total += e - s
        return total * 1e-9

    def blocked(self) -> list:
        """Merged intervals in which the host was held by the device or the
        profiler, up to the start of the window's last synchronisation (the
        harness's own, which closes the window): each CUDA runtime or driver
        call beyond the least time a call of its name took in the window (a
        launch into a full queue waits there for a slot; the least time is
        the call's own cost), and CUPTI's overhead events."""
        calls = [e for e in self.cpu if not e[6] and is_runtime_call(e[2])]
        end = self.w1
        if calls:
            last = max(calls, key=lambda e: e[0])
            if "Synchronize" in last[2]:
                end = last[0]
        least: dict = {}
        for s, e, n, *_ in calls:
            least[n] = min(least.get(n, e - s), e - s)
        held = [(s + least[n], e) for s, e, n, *_ in calls if e - s > least[n]]
        held += [(e[0], e[1]) for e in self.cpu if not e[6] and e[2] in OVERHEAD_NAMES]
        return [[max(s, self.w0), min(e, end)] for s, e in _merge(held)
                if s < end and e > self.w0]

    @property
    def blocked_s(self) -> float:
        return sum(e - s for s, e in self.blocked()) * 1e-9

    def _labels(self):
        """Change points (time, label) of what the host was doing: the
        innermost open span, and the innermost operation inside it."""
        times, labels, stack = [], [], []

        def label():
            spans = [n for _, _, n, ann in stack if ann]
            ops = [n for _, _, n, ann in stack if not ann]
            head = spans[-1] if spans else "no span"
            return f"{head} / {ops[-1]}" if ops else head

        def mark(t):
            times.append(t)
            labels.append(label())

        for s, e, n, _, _, _, ann in sorted(self.cpu, key=lambda x: (x[0], -x[1])):
            while stack and stack[-1][1] <= s:
                mark(stack.pop()[1])
            stack.append((s, e, n, ann))
            mark(s)
        while stack:
            mark(stack.pop()[1])
        return times, labels

    def idle_by_host(self) -> dict:
        """Idle device seconds in the window by what the host was doing at
        the middle of each gap."""
        times, labels = self._labels()
        out: dict = defaultdict(float)
        prev = self.w0
        for s, e in self._merged() + [[self.w1, self.w1]]:
            if s > prev:
                mid = (prev + s) // 2
                i = bisect.bisect_right(times, mid) - 1
                out[labels[i] if i >= 0 else "no span"] += (s - prev) * 1e-9
            prev = max(prev, e)
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": head(self.device_ops()), "idle_gaps": head(self.idle_by_host())}
