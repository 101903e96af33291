"""KKSPGEMM meta-algorithm constants and choosers (port of ``repro/core/meta.py``).

The paper's selection constants are kept verbatim:
  * CPUs/KNLs: KKDENSE when k < 250 000, KKMEM otherwise.
  * GPUs:      KKMEM when average row flops < 256, KKLP otherwise.

Only the static thresholds are ported: the fitted and measured tables of the
reference's autotuner arrive with the port's ``autotune`` slice, so every
decision here records ``*_source == "static"``. Tie directions are part of
the contract: ``avg_row_flops == cutoff`` selects 'flat_lp' and
``dense_bytes == DENSE_BYTES_BUDGET`` still selects 'dense'.
"""
from __future__ import annotations

import numpy as np
import torch

DENSE_K_CUTOFF = 250_000  # paper §3.3
AVG_ROW_FLOPS_CUTOFF = 256  # paper §3.3 (GPU variant selection)
DENSE_BYTES_BUDGET = 1 << 30  # 1 GiB guard for the dense accumulator

# Capacity padding policies for the static caps (fm_cap / nnz_cap). "pow2"
# rounds up to geometric x2 buckets; the plan cache keys on the bucket, so
# the port keeps the reference's buckets to keep its keys and plans equal.
PAD_POLICIES = ("exact8", "pow2")
DEFAULT_PAD_POLICY = "pow2"
CAPACITY_FLOOR = 8


def round_capacity(x: int, policy: str = DEFAULT_PAD_POLICY) -> int:
    """Round a size up to a static capacity under the given pad policy.

    "exact8": next multiple of 8. "pow2": next power of two.
    """
    x = max(int(x), 1)
    if policy == "exact8":
        return max(-(-x // 8) * 8, CAPACITY_FLOOR)
    if policy == "pow2":
        return max(1 << (x - 1).bit_length(), CAPACITY_FLOOR)
    from repro_torch.runtime.validate import SpgemmConfigError
    raise SpgemmConfigError(
        f"unknown pad_policy {policy!r}; expected one of {PAD_POLICIES}")


def f32_accumulation_ok(a_dtype: torch.dtype, b_dtype: torch.dtype) -> bool:
    """May the f32-accumulating replay kernels see these operand dtypes?

    Floating accumulation of at most 4 bytes (f32, f16, bf16 and their
    mixes). f64 would lose half its precision and integers their exactness
    past 2^24: both belong on the plain path. Promotion follows numpy's rules
    as in the reference, not torch's: int32 with f32 promotes to f64 there
    (plain path) where ``torch.promote_types`` gives f32. numpy has no bf16,
    so bf16 stands in as f16, which reaches the same decision for every pair
    the reference accepts.
    """
    acc = np.result_type(*(_NUMPY_STAND_IN.get(d) or torch.empty(0, dtype=d).numpy().dtype
                           for d in (a_dtype, b_dtype)))
    return bool(np.issubdtype(acc, np.floating)) and acc.itemsize <= 4


_NUMPY_STAND_IN = {torch.bfloat16: np.dtype(np.float16)}


def choose_method(a, b, stats: dict) -> str:
    """Return 'dense' or 'sparse'. The dense accumulator is an (m, k) values
    array in the accumulation dtype plus an (m, k) int32 occupancy mask, so
    the memory guard scales with the promoted value dtype. ``stats`` is
    written, not read."""
    k = b.k
    val_itemsize = torch.promote_types(a.values.dtype, b.values.dtype).itemsize
    dense_bytes = a.m * k * (val_itemsize + 4)  # values + int32 occupancy
    stats["dense_bytes"] = dense_bytes
    stats["method_source"] = "static"
    if k < DENSE_K_CUTOFF and dense_bytes <= DENSE_BYTES_BUDGET:
        return "dense"
    return "sparse"


def choose_kernel(a, b, stats: dict) -> str:
    """Return 'dense_acc' or 'flat_lp' — the paper's GPU rule on average row
    flops. ``stats`` must carry ``fm``; a missing ``fm`` raises ``KeyError``
    rather than silently picking 'dense_acc'. The tie at the cutoff goes to
    'flat_lp'."""
    if "fm" not in stats:
        raise KeyError(
            "choose_kernel requires stats['fm'] (total multiplications; see "
            "flops_stats) — a silent fm=0 default would always pick "
            "'dense_acc'")
    fm = max(int(stats["fm"]), 1)
    avg_row_flops = fm / max(a.m, 1)
    stats["avg_row_flops"] = avg_row_flops
    stats["kernel_source"] = "static"
    return "dense_acc" if avg_row_flops < AVG_ROW_FLOPS_CUTOFF else "flat_lp"

