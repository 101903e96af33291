"""Two-phase SpGEMM on torch: the sparse/LP pipeline, plan cache and executor.

Public API:
    spgemm          — the meta-algorithm entry point (methods "sparse", "lp",
                      "dense", "auto")
    symbolic        — the host-mediated symbolic phase (CF <= 0.85 compression rule)
    numeric_reuse   — the Reuse case in plain torch
    ReuseExecutor   — pinned-plan replay engine (single and batched)
    spgemm_grouped  — mixed-structure batch: one replay per structure
    PlanCache       — structure-keyed LRU of reuse plans
    round_capacity  — capacity bucketing policy ("exact8" / "pow2")
"""
from repro_torch.core.accumulators import MAX_OCCUPANCY, accumulate_row
from repro_torch.core.compression import (
    COMPRESSION_CF_CUTOFF,
    CompressedMatrix,
    bitmask_rows,
    compress_matrix,
    compression_decision,
    flops_stats,
)
from repro_torch.core.executor import (
    BACKENDS,
    DISPATCH_COUNTS,
    ReuseExecutor,
    reset_dispatch_counts,
    spgemm_grouped,
)
from repro_torch.core.meta import (
    AVG_ROW_FLOPS_CUTOFF,
    DEFAULT_PAD_POLICY,
    DENSE_K_CUTOFF,
    PAD_POLICIES,
    choose_kernel,
    choose_method,
    f32_accumulation_ok,
    round_capacity,
)
from repro_torch.core.plan_cache import (
    EVICT_COUNTS,
    HASH_COUNTS,
    PlanCache,
    default_plan_cache,
    structure_key,
)
from repro_torch.core.spgemm import (
    STAGE_COUNTS,
    SortedExpansion,
    SpgemmPlan,
    SpgemmResult,
    expand_and_sort,
    expand_products,
    host_fm_cap,
    lp_replay_values,
    numeric_dense_acc,
    numeric_fresh,
    numeric_lp,
    numeric_reuse,
    plan_from_sorted,
    prepare_sparse_inputs,
    reset_stage_counts,
    resolve_plan,
    spgemm,
    symbolic,
    symbolic_compressed,
    symbolic_dense_bitmask,
    symbolic_plain,
)

__all__ = [
    "AVG_ROW_FLOPS_CUTOFF",
    "BACKENDS",
    "COMPRESSION_CF_CUTOFF",
    "CompressedMatrix",
    "DEFAULT_PAD_POLICY",
    "DENSE_K_CUTOFF",
    "DISPATCH_COUNTS",
    "EVICT_COUNTS",
    "HASH_COUNTS",
    "MAX_OCCUPANCY",
    "PAD_POLICIES",
    "PlanCache",
    "ReuseExecutor",
    "STAGE_COUNTS",
    "SortedExpansion",
    "SpgemmPlan",
    "SpgemmResult",
    "accumulate_row",
    "bitmask_rows",
    "choose_kernel",
    "choose_method",
    "compress_matrix",
    "compression_decision",
    "default_plan_cache",
    "expand_and_sort",
    "expand_products",
    "f32_accumulation_ok",
    "flops_stats",
    "host_fm_cap",
    "lp_replay_values",
    "numeric_dense_acc",
    "numeric_fresh",
    "numeric_lp",
    "numeric_reuse",
    "plan_from_sorted",
    "prepare_sparse_inputs",
    "reset_dispatch_counts",
    "reset_stage_counts",
    "resolve_plan",
    "round_capacity",
    "spgemm",
    "spgemm_grouped",
    "structure_key",
    "symbolic",
    "symbolic_compressed",
    "symbolic_dense_bitmask",
    "symbolic_plain",
]
