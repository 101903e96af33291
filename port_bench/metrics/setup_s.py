"""setup_s: seconds from the start of the run's process to the start of its
window: inputs, pins or warm-up, and on a checkout's first run the kernel
build."""


def read(run):
    return run.setup_s
