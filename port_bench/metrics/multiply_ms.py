"""multiply_ms: the window's wall time over the fresh multiplies it
completed, in ms a multiply."""


def read(run):
    if run.entry != "fresh" or run.steps == 0:
        return None
    return run.window_s / run.steps * 1e3
