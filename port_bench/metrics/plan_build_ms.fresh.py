"""plan_build_ms.fresh: device ms a fresh multiply spends in the kernels
launched inside the program's ``plan.build`` span (``expand_and_sort``,
``plan_from_sorted``), from the traced window."""

PROGRAM_SPANS = True  # needs the program's spans as profiler annotations


def read(run):
    if run.trace is None or run.steps == 0 or run.trace.span_count("plan.build") == 0:
        return None
    return run.trace.span_device_s("plan.build") / run.steps * 1e3
