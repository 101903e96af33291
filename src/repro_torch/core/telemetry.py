"""Registry of the port's telemetry counters (port of ``repro/core/telemetry.py``).

Only the counters the port bumps so far are here, each under the
reference's name: ``HASH_COUNTS`` and ``EVICT_COUNTS`` (``core.plan_cache``),
``DISPATCH_COUNTS`` (``core.executor``), ``KERNEL_COUNTS`` (``kernels.ops``),
``FALLBACK_COUNTS`` (below), and ``STAGE_COUNTS`` (``core.spgemm``), which
counts stage calls where the reference's ``TRACE_COUNTS`` counts retraces.
"""
from __future__ import annotations

from collections import Counter

from repro_torch.core.executor import DISPATCH_COUNTS, reset_dispatch_counts
from repro_torch.core.plan_cache import (EVICT_COUNTS, HASH_COUNTS,
                                         reset_evict_counts, reset_hash_counts)
from repro_torch.core.spgemm import STAGE_COUNTS, reset_stage_counts
from repro_torch.kernels.ops import KERNEL_COUNTS, reset_kernel_counts

# Dtype-guard events. Key convention, as in the reference:
#   "dtype:<site>->xla"   the f32-accumulation guard routed a kernel request
#                         to the plain path (sites: "lp", "executor",
#                         "numeric_auto")
FALLBACK_COUNTS: Counter = Counter()


def reset_fallback_counts() -> None:
    FALLBACK_COUNTS.clear()


# name -> live Counter object (shared with the owning module, not copies)
ALL_COUNTERS: dict[str, Counter] = {
    "stage": STAGE_COUNTS,
    "hash": HASH_COUNTS,
    "dispatch": DISPATCH_COUNTS,
    "kernel": KERNEL_COUNTS,
    "fallback": FALLBACK_COUNTS,
    "evict": EVICT_COUNTS,
}

_RESETS = (
    reset_stage_counts,
    reset_hash_counts,
    reset_dispatch_counts,
    reset_kernel_counts,
    reset_fallback_counts,
    reset_evict_counts,
)


def snapshot() -> dict[str, dict[str, int]]:
    """A plain-dict copy of every counter, for diffing across a region."""
    return {name: dict(c) for name, c in ALL_COUNTERS.items()}


def diff(before: dict[str, dict[str, int]],
         after: dict[str, dict[str, int]]) -> dict[str, dict[str, int]]:
    """Nonzero deltas between two ``snapshot()``s, same nested shape; groups
    with no change are omitted."""
    out: dict[str, dict[str, int]] = {}
    for group in before.keys() | after.keys():
        b = before.get(group, {})
        a = after.get(group, {})
        deltas = {key: a.get(key, 0) - b.get(key, 0)
                  for key in b.keys() | a.keys()
                  if a.get(key, 0) != b.get(key, 0)}
        if deltas:
            out[group] = deltas
    return out


def reset_all() -> None:
    """Clear every registered telemetry counter."""
    for reset in _RESETS:
        reset()
