"""Mesh-aware plan cache: sharded plans keyed by structure AND decomposition
(port of ``repro/dist/plan_cache.py``).

A ``ShardedPlan``'s arrays depend on three things: the structural identity
of the multiply (``core.plan_cache.structure_key``: row pointers, live
columns, bucketed caps, pad policy), the shard count of the mesh axis it
was partitioned over, and the B placement (the concat layout and value
perms differ between ``replicated`` and ``allgather``). ``dist_plan_key``
composes them into one key, the reference's string for the same operands,
so a repeated structure on the same decomposition never re-shards, and the
same structure on another shard count misses.

Storage is ``core.plan_cache.PlanCache`` unchanged: the entry-count and
``max_bytes`` bounds apply to sharded plans too (``plan_nbytes`` sums a
plan's tensors). The default cache has a 256 MiB bound: sharded plans pin
S-times stacked replay maps. Under a process group each process caches the
shards it holds.
"""
from __future__ import annotations

from repro_torch.core.plan_cache import PlanCache

DEFAULT_DIST_CACHE_BYTES = 256 << 20


def dist_plan_key(structure_key: str, num_shards: int, b_placement: str) -> str:
    """The mesh-aware cache key. Only the shard count joins it (not devices,
    ranks or the axis name): a plan's arrays are a function of (structure,
    S, placement), so two meshes of one axis size share an entry."""
    return f"{structure_key}:S{num_shards}:{b_placement}"


_DEFAULT_DIST_CACHE = PlanCache(capacity=16, max_bytes=DEFAULT_DIST_CACHE_BYTES,
                                name="dist")


def default_dist_plan_cache() -> PlanCache:
    """The module-level mesh-aware cache used when none is passed."""
    return _DEFAULT_DIST_CACHE
