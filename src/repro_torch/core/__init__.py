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
    fit_thresholds  — per-backend crossover fit from accumulator timing rows
                      (static < fitted < measured; see core.autotune)
    TunedThresholds — the fitted table; activate with set_tuned_thresholds
"""
from repro_torch.core.accumulators import MAX_OCCUPANCY, accumulate_row
from repro_torch.core.autotune import (
    TUNE_COUNTS,
    BackendFit,
    TunedThresholds,
    fit_thresholds,
    get_tuned_thresholds,
    load_thresholds,
    reset_tune_counts,
    set_tuned_thresholds,
)
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
    ARS_REDUCTION_GUESS,
    AVG_ROW_FLOPS_CUTOFF,
    DEFAULT_PAD_POLICY,
    DENSE_K_CUTOFF,
    PAD_POLICIES,
    choose_kernel,
    choose_method,
    estimate_ars,
    f32_accumulation_ok,
    round_capacity,
)
from repro_torch.core.plan_cache import (
    EVICT_COUNTS,
    HASH_COUNTS,
    PlanCache,
    default_plan_cache,
    plan_nbytes,
    reset_hash_counts,
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
    "ARS_REDUCTION_GUESS",
    "AVG_ROW_FLOPS_CUTOFF",
    "BACKENDS",
    "BackendFit",
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
    "TUNE_COUNTS",
    "TunedThresholds",
    "accumulate_row",
    "bitmask_rows",
    "choose_kernel",
    "choose_method",
    "compress_matrix",
    "compression_decision",
    "default_plan_cache",
    "estimate_ars",
    "expand_and_sort",
    "expand_products",
    "f32_accumulation_ok",
    "fit_thresholds",
    "flops_stats",
    "get_tuned_thresholds",
    "host_fm_cap",
    "load_thresholds",
    "lp_replay_values",
    "numeric_dense_acc",
    "numeric_fresh",
    "numeric_lp",
    "numeric_reuse",
    "plan_from_sorted",
    "plan_nbytes",
    "prepare_sparse_inputs",
    "reset_dispatch_counts",
    "reset_hash_counts",
    "reset_stage_counts",
    "reset_tune_counts",
    "resolve_plan",
    "round_capacity",
    "set_tuned_thresholds",
    "spgemm",
    "spgemm_grouped",
    "structure_key",
    "symbolic",
    "symbolic_compressed",
    "symbolic_dense_bitmask",
    "symbolic_plain",
]
