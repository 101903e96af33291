"""host_reads.fresh: the device->host copies a step in the traced window,
from the device's own record (the profiler's ``Memcpy DtoH`` activities).
Each ``int()``, ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()`` of a
device value copies it to the host before the host reads it, and so does
each implicit read (``torch.nonzero``, a boolean mask, ``if t.any():``), so
the count does not rest on what the program marks: its ``host.read`` spans
only label these waits in the idle breakdown. Nothing where the window
holds no device operation."""


def read(run):
    t = run.trace
    if t is None or run.steps == 0 or t.device_events == 0:
        return None
    return sum(1 for _, _, name, _ in t.dev if name.startswith("Memcpy DtoH")) / run.steps
