"""replay_host_us.reuse: the host's cost of one replay call
(``ReuseExecutor.apply``), in us, from the traced window.

The harness times each replay call on the host (its own span around
``system.replay``, two clock reads, in traced runs only); from their sum it
takes away the time in which the host was held inside them
(``TraceData.blocked``): a loop that issues replays back to back fills the
launch queue, and each launch then waits for a slot for as long as the
device takes. What is left, over the calls, is the host's cost of issuing a
replay: the executor's Python, its dispatch and its launches at their own
cost. The harness's loop between calls is not in it.

It moves ``replay_ms`` only where the host sets the pace: in a device-bound
cell (idle a few %) it is the headroom a faster kernel has before the host
holds it back."""


def read(run):
    if run.trace is None or run.calls == 0 or run.trace.device_events == 0:
        return None
    return (run.call_host_s - run.trace.blocked_s) / run.calls * 1e6
