"""K2 and K3: the paper's LP hash accumulator, in CUDA (``csrc/lp_reuse.cu``,
``csrc/spgemm_lp.cu``). Port of ``repro/kernels/spgemm_lp.py``.

K3 ``spgemm_lp`` replaces the Pallas TPU kernel ``spgemm_lp``: the Gustavson
numeric phase over ELL operands through the paper's two-level LP scheme.
Per row, an L1 table with the 50% max-occupancy rule (past the cutoff a new
key spills, keys already in L1 still accumulate) and an L2 table that holds
every spill; C's value at a column is L1's plus L2's. B's padded slots are
masked by ``b_nnz``; the output is in ``promote_types(a, b)``. Every key's
products are summed in one table (or, after a race on the card, in both,
which the emit adds), so the values do not depend on the table sizes: the
kernel sizes L1 per row, at the next power of two >= 2 * c_nnz[i], unless
the caller forces ``l1_size`` (which makes rows spill), and gives a row an
L2 only where it can spill. What bounds it on the H100: bytes, as K4. The
design: one block per row, tables in shared memory for rows up to 16,384
slots and in device memory, allocated here, for wider ones (see the
source's header).

K2 ``lp_reuse_arrays`` replaces ``lp_reuse_arrays``: the Reuse-case replay
of ``segsum_reuse`` with the in-tile reduction through a 256-slot LP table
per 128-product tile (one ``atomicAdd`` per occupied slot). Same contract as
K1: ``C[seg_ids[t]] += A[a_slot_s[t]] * B[b_slot_s[t]]``, f32 accumulation
cast to ``promote_types(a, b)``, sentinel dropped; bytes-bound as K1.

Beside the kernels: ``spgemm_lp_plain`` (which sums each key's products in
the order of the insert stream, so on the CPU it is bitwise the reference's
``ref.spgemm_lp_ref``) and ``lp_reuse_plain`` (the same function as
``segsum_reuse_plain``, since the table only reorders the adds), which the
wrappers run for CPU tensors only; ``NUMERIC_LAUNCHES`` (K3) and
``LAUNCHES`` (K2) count kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segsum_reuse import (check_replay_args, launch_replay,
                                              replay_plain)
from repro_torch.kernels.spgemm_numeric import (_pad_width, check_ell_args,
                                                ell_numeric_plain, launch_ell)
from repro_torch.runtime.validate import SpgemmConfigError, SpgemmInputError

# kernel launches by ``lp_reuse_arrays`` (K2) and ``spgemm_lp`` (K3); reset
# by callers that count
LAUNCHES = 0
NUMERIC_LAUNCHES = 0

LP_TILE = 128  # products per block; the table holds 2 * LP_TILE slots

# K3's size classes of per-row table slots (csrc/spgemm_lp.cu): up to
# SMALL_SLOTS in 16 KiB of shared memory, up to MID_SLOTS in 128 KiB, wider
# rows in device memory
SMALL_SLOTS = 2048
MID_SLOTS = 16384


def _next_pow2(x: int) -> int:
    # deliberately not core.meta.round_capacity("pow2"): table sizes are a
    # hash invariant and must not follow the capacity-bucketing policy
    return 1 << (max(int(x), 1) - 1).bit_length()


def default_l1_size(r_c: int) -> int:
    """The reference's L1 table size for an rC-wide output: the next power
    of two >= 2 * rC (at least 8), which the 50% rule never spills."""
    return _next_pow2(max(2 * r_c, 8))


def _next_pow2_tensor(x: torch.Tensor) -> torch.Tensor:
    v = x.to(torch.int64) - 1
    for shift in (1, 2, 4, 8, 16, 32):
        v = v | (v >> shift)
    return v + 1


def lp_table_slots(c_nnz: torch.Tensor, r_c: int, l1_size: int | None) -> torch.Tensor:
    """(m,) int64: the slots of each row's tables in K3 — L1 (``l1_size``, or
    the next power of two >= 2 * c_nnz[i], at least 8) plus L2 (the latter
    size) where L1's cutoff is below c_nnz[i]; 0 for an empty row. The same
    formula as the kernel's."""
    cn = c_nnz.clamp(0, r_c).to(torch.int64)
    s2 = _next_pow2_tensor((2 * cn).clamp(min=8))
    s1 = s2 if l1_size is None else torch.full_like(s2, l1_size)
    has_l2 = torch.minimum(s1 // 2, s1 - 1) < cn
    return torch.where(cn > 0, s1 + torch.where(has_l2, s2, 0), 0)


def _check_l1_size(l1_size) -> None:
    if l1_size is not None and (l1_size < 2 or l1_size & (l1_size - 1)
                                or l1_size >= 2**30):
        raise SpgemmConfigError(
            f"l1_size must be a power of two in [2, 2^30); got {l1_size}")


def spgemm_lp_plain(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz, *,
                    l1_size: int | None = None, k: int | None = None) -> torch.Tensor:
    """``spgemm_lp`` in plain torch: each (row, column)'s f32 products summed
    in the order of the insert stream (A slots row-major, then the B row's
    live slots), read at ``c_idx``/``c_nnz``, out in ``promote_types(a, b)``.
    ``l1_size`` changes which table holds a key, never its sum, so it is only
    checked. ``k`` bounds B's columns (default: one past the largest)."""
    _check_l1_size(l1_size)
    if k is None:
        k = _column_bound(b_idx, c_idx)
    return ell_numeric_plain(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz,
                             k, torch.float32,
                             torch.promote_types(a_val.dtype, b_val.dtype))


def _column_bound(b_idx, c_idx) -> int:
    """One past the largest column id of B's and C's ELL arrays (at least 1):
    the reference's LP kernel takes no k, and keys need no bound there."""
    top = max(int(b_idx.max()) if b_idx.numel() else 0,
              int(c_idx.max()) if c_idx.numel() else 0)
    return max(top + 1, 1)


def spgemm_lp(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz, *,
              l1_size: int | None = None, k: int | None = None) -> torch.Tensor:
    """LP-hash numeric phase: C values (ELL layout, (m, rC), in
    ``promote_types(a, b)``) at the given structure, through the two-level
    L1/L2 LP scheme.

    a_idx/a_val: (m, rA) ELL of A; a_nnz: (m,); b_idx/b_val: (n, rB) ELL of B;
    b_nnz: (n,) live B widths (padded B slots are masked, not relied on to
    carry 0); c_idx: (m, rC) symbolic structure of C; c_nnz: (m,) — each
    row's number of distinct columns, which sizes its tables. Values are f32,
    f16 or bf16 (f32 accumulation). ``l1_size``: a power of two forcing
    every row's L1 size (rows then spill to L2); None sizes L1 per row so
    that it never spills. ``k``: B's number of columns; a product whose
    column lies outside [0, k) is dropped (default: one past the largest
    column id in B's and C's arrays). CUDA tensors launch the kernel (or
    raise); CPU tensors run ``spgemm_lp_plain``.
    """
    global NUMERIC_LAUNCHES
    if k is None:
        k = _column_bound(b_idx, c_idx)
    check_ell_args(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz, k)
    if b_nnz is None:
        raise SpgemmInputError("spgemm_lp needs b_nnz: B's padded slots are masked")
    _check_l1_size(l1_size)
    if a_idx.device.type == "cpu":
        return spgemm_lp_plain(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz,
                               l1_size=l1_size, k=k)
    out = torch.empty(c_idx.shape, dtype=torch.float32, device=a_idx.device)
    if out.numel():
        slots = lp_table_slots(c_nnz, c_idx.shape[1], l1_size)
        cls = (slots > SMALL_SLOTS).to(torch.int8) + (slots > MID_SLOTS).to(torch.int8)
        rows = [torch.nonzero(cls == c).flatten().to(torch.int32) for c in range(3)]
        big = slots[rows[2].long()]
        g_off = g_ids = g_vals = None
        if big.numel():
            g_off = torch.zeros_like(big)
            g_off[1:] = torch.cumsum(big, 0)[:-1]
            total = int(big.sum())
            g_ids = torch.empty(total, dtype=torch.int32, device=a_idx.device)
            g_vals = torch.empty(total, dtype=torch.float32, device=a_idx.device)
        launch_ell("spgemm_lp", a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx,
                   c_nnz, out, k, l1_size=l1_size or 0, rows=rows, g_off=g_off,
                   g_ids=g_ids, g_vals=g_vals)
        NUMERIC_LAUNCHES += 1
    return out.to(torch.promote_types(a_val.dtype, b_val.dtype))


def spgemm_lp_bucketed(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz, *,
                       l1_size: int | None = None, pad_policy: str | None = None,
                       k: int | None = None) -> torch.Tensor:
    """``spgemm_lp`` with ELL widths rA/rB/rC padded to capacity buckets (the
    contract of ``spgemm_numeric_bucketed``); output sliced back to the
    caller's rC. Padded slots are masked by ``a_nnz``, ``b_nnz`` and
    ``c_nnz``."""
    from repro_torch.core.meta import DEFAULT_PAD_POLICY, round_capacity

    policy = DEFAULT_PAD_POLICY if pad_policy is None else pad_policy
    r_c = c_idx.shape[1]
    a_idx = _pad_width(a_idx, round_capacity(a_idx.shape[1], policy))
    a_val = _pad_width(a_val, a_idx.shape[1])
    b_idx = _pad_width(b_idx, round_capacity(b_idx.shape[1], policy))
    b_val = _pad_width(b_val, b_idx.shape[1])
    c_idx_p = _pad_width(c_idx, round_capacity(r_c, policy))
    out = spgemm_lp(a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx_p, c_nnz,
                    l1_size=l1_size, k=k)
    return out[:, :r_c]


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
