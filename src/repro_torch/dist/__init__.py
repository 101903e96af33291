"""repro_torch.dist — the sharded two-phase SpGEMM (port of ``repro.dist``).

The paper's Reuse case pays off when symbolic structures are reused across
numeric calls, and SpGEMM reaches scale when that node-level kernel
composes with a distributed decomposition. This package is that
composition: the plan lifecycle lifted onto a mesh (``repro_torch.compat``:
every shard on one device, or shards split over a ``torch.distributed``
process group).

    ShardedPlan          — stacked per-shard SpgemmPlan, uniform bucketed
                           caps, pinned value-routing perms (plan.py)
    build_sharded_plan   — one sharded expand+sort and one host cap-sync
    ShardedReuseExecutor — pin per-shard plans once, replay each shard; on
                           the card through the K1 replay kernel, a launch
                           a shard (executor.py)
    sharded_spgemm       — the entry point behind spgemm(..., mesh=...)
    dist_plan_key        — mesh-aware cache key: (structure, S, placement)
    default_dist_plan_cache — bytes-bounded LRU of sharded plans

B placements (see core/distributed.py): ``replicated`` trades memory for no
communication; ``allgather`` row-shards B and all-gathers its values on
every replay, its structure once at pin time.

Also here: compressed collectives (collectives.py) and GPipe-style pipeline
parallelism (pipeline.py).
"""
from repro_torch.dist.collectives import (
    compressed_psum,
    dequantize_int8,
    quantize_int8,
    topk_compress,
    topk_decompress,
)
from repro_torch.dist.executor import ShardedReuseExecutor, sharded_spgemm
from repro_torch.dist.pipeline import pipeline_forward
from repro_torch.dist.plan import (
    B_PLACEMENTS,
    ShardedPlan,
    build_sharded_plan,
    dist_expand_and_sort,
)
from repro_torch.dist.plan_cache import (
    DEFAULT_DIST_CACHE_BYTES,
    default_dist_plan_cache,
    dist_plan_key,
)

__all__ = [
    "B_PLACEMENTS",
    "ShardedPlan",
    "ShardedReuseExecutor",
    "build_sharded_plan",
    "dist_expand_and_sort",
    "sharded_spgemm",
    "dist_plan_key",
    "default_dist_plan_cache",
    "DEFAULT_DIST_CACHE_BYTES",
    "compressed_psum",
    "quantize_int8",
    "dequantize_int8",
    "topk_compress",
    "topk_decompress",
    "pipeline_forward",
]
