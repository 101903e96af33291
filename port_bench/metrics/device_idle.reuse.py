"""device_idle: the share of the traced window, in %, in which no operation
ran on the device (the trace's busy seconds over the window's length);
nothing where no operation ran on a device at all."""


def read(run):
    if run.trace is None or run.trace.device_events == 0 or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
