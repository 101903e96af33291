"""The degradation ladder shared by ``kernels.ops.numeric_values`` and
``core.executor.ReuseExecutor``.

``walk`` runs the first rung and, when a rung fails as a kernel fails,
steps to the next: ``FALLBACK_COUNTS["fault:<failed>-><next>"]`` and one
flight-recorder "fallback" event per step. Under
``on_kernel_failure="raise"``, or when the rungs run out, the failure
becomes ``KernelFallbackError``.

A kernel failure is a launch that returned a CUDA error
(``kernels._build.KernelLaunchError``) or an armed ``kernel:<name>``
failpoint (``runtime.faults.InjectedFault``). Nothing else is caught: typed
errors (bad operands, a kernel library that cannot be built or loaded),
watchdog verdicts, out-of-memory and plain bugs pass through untouched.

Which rungs a caller offers depends on where the operands live
(``kernels_only``): on the card every rung is a hand-written kernel, so a
failed kernel can never hand its work to the plain version; on the CPU the
reference's ladder ends in the plain "xla" rung.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

from repro_torch.obs import recorder
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import faults
from repro_torch.runtime.validate import KernelFallbackError, SpgemmConfigError

ON_KERNEL_FAILURE = ("fallback", "raise")


def kernels_only(device: torch.device) -> bool:
    """True where the rungs must all be kernels: any device but the CPU."""
    return device.type != "cpu"


def check_policy(on_kernel_failure: str) -> None:
    if on_kernel_failure not in ON_KERNEL_FAILURE:
        raise SpgemmConfigError(
            f"on_kernel_failure must be 'fallback' or 'raise', got "
            f"{on_kernel_failure!r}")


def _is_kernel_failure(e: BaseException) -> bool:
    from repro_torch.kernels._build import KernelLaunchError  # cycle-free

    return isinstance(e, (KernelLaunchError, faults.InjectedFault))


def walk(rungs: Sequence[str], run: Callable[[str], torch.Tensor], *,
         on_kernel_failure: str, site: str, what: str,
         kernel_span: bool = False, on_step: Callable[[str], None] | None = None,
         **attrs) -> tuple[torch.Tensor, str]:
    """Run ``run(rungs[0])``, stepping down ``rungs`` on kernel failures;
    returns the output and the rung that gave it.

    ``faults.check(f"kernel:<rung>")`` precedes each rung, inside a
    ``numeric.kernel`` span when ``kernel_span`` is set. ``what`` names the rung kind in
    the error message; ``site`` and ``attrs`` go to the recorder;
    ``on_step(step)`` sees each "<failed>-><next>" step.
    """
    from repro_torch.core.telemetry import FALLBACK_COUNTS  # cycle-free

    for i, name in enumerate(rungs):
        try:
            with (obs_trace.span("numeric.kernel", kernel=name, rung=i) if kernel_span
                  else contextlib.nullcontext()):
                faults.check(f"kernel:{name}")
                return run(name), name
        except Exception as e:
            if not _is_kernel_failure(e):
                raise
            if on_kernel_failure == "raise" or i + 1 >= len(rungs):
                err = KernelFallbackError(
                    f"{what} {name!r} failed and on_kernel_failure='raise'"
                    if on_kernel_failure == "raise" else
                    f"{what} ladder exhausted ({' -> '.join(rungs)})")
                recorder.note_error(err, kernel=name, site=site,
                                    trace_id=obs_trace.current_trace_id(), **attrs)
                raise err from e
            step = f"{name}->{rungs[i + 1]}"
            FALLBACK_COUNTS[f"fault:{name}->{rungs[i + 1]}"] += 1
            recorder.record("fallback", kernel=name, fallback=step, verdict="fallback",
                            site=site, trace_id=obs_trace.current_trace_id(), **attrs)
            if on_step is not None:
                on_step(step)
