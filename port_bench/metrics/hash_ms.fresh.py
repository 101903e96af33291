"""hash_ms.fresh: host wall ms a step inside the program's ``plan.hash``
spans (``core.plan_cache.structure_key``: its device->host copies and the
digest), from the traced window: the spans' host events, cut to the window,
summed, over the steps. A hash computed on the device and read back still
runs inside the span, so this reads the layer whatever implements it.
Nothing where the program records no ``plan.hash`` span."""

PROGRAM_SPANS = True  # needs the program's spans as profiler annotations


def read(run):
    if run.trace is None or run.steps == 0 or run.trace.span_count("plan.hash") == 0:
        return None
    t = run.trace
    ns = sum(min(e[1], t.w1) - max(e[0], t.w0) for e in t.cpu if e[6] and e[2] == "plan.hash")
    return ns * 1e-6 / run.steps
