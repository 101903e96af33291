"""peak_mem_gib: the device memory the program held at most during the
window (``torch.cuda.max_memory_allocated`` after a reset at its start,
less the bytes of the few answers the harness keeps for its check), in GiB:
its plans, operands, the answers of a step and their transients, read
before the reference runs."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes > 0 else None
