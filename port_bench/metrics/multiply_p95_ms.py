"""multiply_p95_ms: the 95th percentile of the latency of every fresh
multiply in the window, host clock from the call to C being ready on the
device, in ms."""

import numpy as np


def read(run):
    if run.entry != "fresh" or not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3
