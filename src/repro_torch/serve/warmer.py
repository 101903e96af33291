"""Traffic-log driven plan-cache warming for the serving tier (port of
``repro/serve/warmer.py``, on the port's ``prepare_sparse_inputs``,
``structure_key``, ``resolve_plan`` and ``EVICT_COUNTS``).

A reuse-oriented serving tier lives or dies on steady-state cache behavior:
the first request of every structure pays the full expand+sort plan build,
so a cold cache turns the head of a traffic burst into a latency cliff. The
warmer moves that cost off the serving path: record the structures a
service actually saw (``TrafficLog``), then replay the log's hottest
structures through ``resolve_plan`` into a plan cache *before* traffic
arrives (``warm_plan_cache``).

Warming is best-effort by design and must tolerate eviction mid-stream:

  * a log bigger than the cache simply churns the LRU — the warmer keeps
    going, and the eviction churn is visible in ``telemetry.EVICT_COUNTS``
    (the returned stats carry the delta, so callers can detect a warm set
    that does not fit instead of wondering why replays are cold);
  * an exemplar whose plan build fails (corrupt structure recorded from a
    hostile trace) is skipped and counted, never fatal;
  * warming an already-resident structure is a cheap cache hit.

The log stores one structure *exemplar* per structure key (operands are
kept with their prepared/bucketed buffers so the warm-time plan is
byte-identical to the serve-time plan) plus a hit count; values ride along
but are irrelevant to the plan. ``TrafficLog.record`` hashes the structure
(one ``structure_key`` per call — the same unavoidable minimum as the
grouped dispatch); the serving tier's internal recording reuses the key it
already computed at admission, adding zero extra hashes.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

from repro_torch.core.meta import DEFAULT_PAD_POLICY
from repro_torch.core.plan_cache import EVICT_COUNTS, structure_key
from repro_torch.core.spgemm import prepare_sparse_inputs, resolve_plan
from repro_torch.runtime.validate import SpgemmError


class TrafficEntry(NamedTuple):
    """One distinct structure observed in traffic."""

    skey: str  # structure_key of the prepared operands
    a: object  # prepared (bucketed) CSR exemplars
    b: object
    fm_cap: int
    count: int  # how many requests carried this structure


class TrafficLog:
    """Structure-frequency log of a request stream.

    ``record(a, b)`` prepares/buckets the operands exactly like the serving
    path (so the recorded key matches what dispatch will look up) and keeps
    the first-seen exemplar per structure with a running count.
    """

    def __init__(self, pad_policy: str | None = None):
        self.pad_policy = DEFAULT_PAD_POLICY if pad_policy is None else pad_policy
        self._entries: OrderedDict[str, TrafficEntry] = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def record(self, a, b) -> str:
        """Log one request's structure; returns its structure key."""
        a, b, _, _, fm_cap = prepare_sparse_inputs(a, b, self.pad_policy)
        skey = structure_key(a, b, fm_cap, self.pad_policy)
        return self.record_prepared(skey, a, b, fm_cap)

    def record_prepared(self, skey: str, a, b, fm_cap: int) -> str:
        """Log a structure the caller already prepared and hashed (the
        serving tier's admission path — no second digest)."""
        hit = self._entries.get(skey)
        if hit is None:
            self._entries[skey] = TrafficEntry(skey, a, b, fm_cap, 1)
        else:
            self._entries[skey] = hit._replace(count=hit.count + 1)
        return skey

    def top(self, n: int | None = None) -> list[TrafficEntry]:
        """Entries by descending traffic count (ties: first-seen first)."""
        ranked = sorted(self._entries.values(),
                        key=lambda e: -e.count)
        return ranked if n is None else ranked[:n]


def warm_plan_cache(log: TrafficLog, cache, limit: int | None = None) -> dict:
    """Prefetch plans for the log's hottest structures into ``cache``.

    Returns warm stats: ``built`` (plans constructed), ``hits`` (already
    resident), ``failed`` (exemplars whose plan build raised a typed error
    — skipped, warming continues), and ``evictions`` (LRU churn during the
    warm, from ``EVICT_COUNTS[cache.name]`` — nonzero means the warm set
    exceeds the cache bound and the tail of the warm evicted its head).
    """
    evict0 = EVICT_COUNTS[cache.name]
    built = hits = failed = 0
    for entry in log.top(limit):
        try:
            _, state, _ = resolve_plan(entry.a, entry.b, entry.fm_cap,
                                       log.pad_policy, cache, key=entry.skey)
        except SpgemmError:
            failed += 1
            continue
        if state == "hit":
            hits += 1
        else:
            built += 1
    return {
        "built": built,
        "hits": hits,
        "failed": failed,
        "evictions": EVICT_COUNTS[cache.name] - evict0,
    }
