"""K2: the Reuse-case replay through an LP hash table, in CUDA (``csrc/lp_reuse.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/spgemm_lp.py``
(``lp_reuse_arrays``). Same contract as ``segsum_reuse``: for every product t
of a precomposed plan, ``C[seg_ids[t]] += A[a_slot_s[t]] * B[b_slot_s[t]]``,
f32 accumulation cast to ``promote_types(a, b)``, sentinel dropped. Only the
in-tile reduction differs: each 128-product block hashes its segment offsets
into a 256-slot linear-probing table in shared memory, then flushes the table
with one ``atomicAdd`` per occupied slot. The numeric LP kernel of this
module's reference (``spgemm_lp``, K3) comes with a later slice.

What bounds it on the H100: bytes, as K1 — 12 B of plan per product, two
random value reads, ``4 * nnz_cap`` bytes written — plus the table's
shared-memory atomics, which stay on the SM.

Beside the kernel: ``lp_reuse_plain``, which runs for CPU tensors only. The
LP table changes only the order of the adds, so it is the same plain
function as ``segsum_reuse_plain``. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segsum_reuse import (check_replay_args, launch_replay,
                                              replay_plain)

# kernel launches by ``lp_reuse_arrays`` (reset by callers that count)
LAUNCHES = 0

LP_TILE = 128  # products per block; the table holds 2 * LP_TILE slots


def lp_reuse_plain(a_slot_s, b_slot_s, seg_ids, a_values, b_values,
                   nnz_cap: int) -> torch.Tensor:
    """``lp_reuse_arrays`` in plain torch: the same function as
    ``segsum_reuse_plain``, since the table only reorders the adds."""
    return replay_plain(a_slot_s, b_slot_s, seg_ids, a_values, b_values, nnz_cap)


def lp_reuse_arrays(a_slot_s, b_slot_s, seg_ids, a_values, b_values, *,
                    nnz_cap: int) -> torch.Tensor:
    """LP-table replay on raw plan arrays. Returns (nnz_cap,) C values.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``lp_reuse_plain``.
    """
    global LAUNCHES
    check_replay_args(a_slot_s, b_slot_s, seg_ids, a_values, b_values, nnz_cap)
    if a_values.device.type == "cpu":
        return lp_reuse_plain(a_slot_s, b_slot_s, seg_ids, a_values, b_values,
                              nnz_cap)
    out = torch.zeros(nnz_cap, dtype=torch.float32, device=a_values.device)
    if seg_ids.shape[0] > 0 and nnz_cap > 0:
        launch_replay("lp_reuse", a_slot_s, b_slot_s, seg_ids, a_values,
                      b_values, out)
        LAUNCHES += 1
    return out.to(torch.promote_types(a_values.dtype, b_values.dtype))


def lp_reuse(plan, a_values, b_values) -> torch.Tensor:
    """Replay a ``SpgemmPlan`` through the LP-table kernel. Select it through
    ``ReuseExecutor(..., backend="pallas_lp")`` or ``spgemm(method="lp")``.
    f32 accumulation: f64/int operands belong on the plain path."""
    return lp_reuse_arrays(plan.a_slot_s, plan.b_slot_s, plan.seg_ids,
                           a_values, b_values, nnz_cap=plan.indices.shape[0])
