"""Registry of the port's telemetry counters (port of ``repro/core/telemetry.py``).

Every subsystem keeps its own module-level ``Counter`` next to the code it
instruments, under the reference's name: ``HASH_COUNTS`` and
``EVICT_COUNTS`` (``core.plan_cache``), ``DISPATCH_COUNTS``
(``core.executor``), ``KERNEL_COUNTS`` (``kernels.ops``), ``TUNE_COUNTS``
(``core.autotune``), and ``FALLBACK_COUNTS``, ``RETRY_COUNTS`` and
``BREAKER_COUNTS`` (below). ``STAGE_COUNTS`` (``core.spgemm``) stands under
the family name "trace" in the place of the reference's ``TRACE_COUNTS``:
it counts stage calls where the reference counts retraces, since eager
PyTorch never retraces. This module aggregates them so tests can snapshot
or reset all instrumentation in one call.

``reset_all()`` clears counters only — the autotuner's fitted table and
measured buckets are ``autotune.reset_tuner()``.
"""
from __future__ import annotations

import re
from collections import Counter

from repro_torch.core.autotune import TUNE_COUNTS, reset_tune_counts
from repro_torch.core.executor import DISPATCH_COUNTS, reset_dispatch_counts
from repro_torch.core.plan_cache import (EVICT_COUNTS, HASH_COUNTS,
                                         reset_evict_counts, reset_hash_counts)
from repro_torch.core.spgemm import STAGE_COUNTS, reset_stage_counts
from repro_torch.kernels.ops import KERNEL_COUNTS, reset_kernel_counts

# Degradation-ladder / guard events. Key conventions, as in the reference:
#   "fault:<kernel>-><next>"   ladder step after a kernel failure
#   "dtype:<site>->xla"        f32-accumulation guard rerouted to the plain
#                              path (sites: "lp", "executor", "numeric_auto")
#   "nan_guard:rerun"          guard saw non-finite output, reran the plain
#                              replay
#   "nan_guard:recovered"      the rerun was finite (kernel-side fault)
#   "nan_guard:data"           the rerun was still non-finite (operand NaN)
FALLBACK_COUNTS: Counter = Counter()


def reset_fallback_counts() -> None:
    FALLBACK_COUNTS.clear()


# Retry telemetry, bumped by ``runtime.retry.retry_call``, per callsite label:
#   "<label>:attempt", "<label>:retry", "<label>:giveup"
RETRY_COUNTS: Counter = Counter()


def reset_retry_counts() -> None:
    RETRY_COUNTS.clear()


# Circuit-breaker telemetry, keyed "<breaker name>:<event>" (open, half_open,
# close, reopen, short_circuit). Its users come with the port's serve/ slice;
# the family belongs to the registry.
BREAKER_COUNTS: Counter = Counter()


def reset_breaker_counts() -> None:
    BREAKER_COUNTS.clear()


# Machine-readable key grammars, one family per registered counter (the
# reference's, so a key valid in one package is valid in the other). ``{}``
# is a wildcard segment (kernel names, callsite labels, breaker names).
KEY_FAMILIES: dict[str, tuple[str, ...]] = {
    "trace": ("{}",),
    "hash": ("structure_key",),
    "dispatch": ("apply", "apply_batched", "dist_apply", "dist_apply_batched"),
    "kernel": ("{}",),
    "tune": ("micro_bench", "bucket_hit", "plan_meta_hit"),
    "fallback": ("fault:{}->{}", "dtype:{}->xla", "nan_guard:rerun",
                 "nan_guard:recovered", "nan_guard:data"),
    "evict": ("{}",),
    "retry": ("{}:attempt", "{}:retry", "{}:giveup"),
    "breaker": ("{}:open", "{}:half_open", "{}:close", "{}:reopen",
                "{}:short_circuit"),
}


def key_matches_family(family: str, key: str) -> bool:
    """Does ``key`` fit one of ``family``'s grammar templates?"""
    for template in KEY_FAMILIES.get(family, ()):
        pattern = "^" + ".+".join(
            re.escape(part) for part in template.split("{}")) + "$"
        if re.match(pattern, key):
            return True
    return False


# name -> live Counter object (shared with the owning module, not copies)
ALL_COUNTERS: dict[str, Counter] = {
    "trace": STAGE_COUNTS,
    "hash": HASH_COUNTS,
    "dispatch": DISPATCH_COUNTS,
    "kernel": KERNEL_COUNTS,
    "tune": TUNE_COUNTS,
    "fallback": FALLBACK_COUNTS,
    "evict": EVICT_COUNTS,
    "retry": RETRY_COUNTS,
    "breaker": BREAKER_COUNTS,
}

_RESETS = (
    reset_stage_counts,
    reset_hash_counts,
    reset_dispatch_counts,
    reset_kernel_counts,
    reset_tune_counts,
    reset_fallback_counts,
    reset_evict_counts,
    reset_retry_counts,
    reset_breaker_counts,
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
