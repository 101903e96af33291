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
kernel gives a row one table of the next power of two >= 2 * c_nnz[i]
slots, and an L1 of the caller's ``l1_size`` beside such an L2 only where
c_nnz[i] is past that L1's cutoff, so the row can spill. A row whose
products reach more columns than its c_nnz (a structure that lists fewer
columns than the product has) fills its last table: the kernel lists it,
and the wrapper runs those rows again in tables sized by their product
counts, which cannot fill. What bounds it on the H100: bytes, as K4. The
design (see the source's header): the wrapper bins the non-empty rows on
the device into size classes (``lp_bins``), each class's shared memory its
largest table; small rows are packed many to a block, 4 to 32 lanes each,
wider ones take a block, and rows beyond 16,384 slots get tables in
device memory, allocated here. A team of lanes walks its row's products
flat, one product per lane, into tables keyed by a multiplicative hash.

K2 ``lp_reuse_arrays`` replaces ``lp_reuse_arrays``: the Reuse-case replay
of ``segsum_reuse`` with the in-tile reduction through an LP table in shared
memory: 2,048 slots (at most 50% full) per tile of 1,024 products, four a
thread, each thread's run of one key summed in registers before its insert;
the flush writes each segment once and the slots no product reaches 0, with
the carries and ends of K1 (``csrc/replay_tile.cuh``), so the output needs
no fill. Same contract as K1: ``C[seg_ids[t]] += A[a_slot_s[t]] *
B[b_slot_s[t]]``, f32 accumulation cast to ``promote_types(a, b)``, ids
outside ``[0, nnz_cap)`` dropped, seg_ids sorted; bytes-bound as K1. Like
K1 it has a batched launch over stacked values, ``lp_reuse_batched_arrays``.

Beside the kernels: ``spgemm_lp_plain`` (which sums each key's products in
the order of the insert stream, so on the CPU it is bitwise the reference's
``ref.spgemm_lp_ref``) and ``lp_reuse_plain`` (the same function as
``segsum_reuse_plain``, since the table only reorders the adds) and
``lp_reuse_batched_plain``, which the wrappers run for CPU tensors only;
``NUMERIC_LAUNCHES`` (K3), ``LAUNCHES`` and ``BATCHED_LAUNCHES`` (K2) count
kernel launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.segsum_reuse import (check_replay_args, launch_replay,
                                              replay_batched_plain, replay_out,
                                              replay_plain, run_batched)
from repro_torch.kernels.spgemm_numeric import (_pad_width, check_ell_args,
                                                ell_numeric_plain, launch_ell)
from repro_torch.obs.trace import span
from repro_torch.runtime.validate import SpgemmConfigError, SpgemmInputError

# kernel launches by ``lp_reuse_arrays`` (K2), ``lp_reuse_batched_arrays``
# (K2's batched launch) and ``spgemm_lp`` (K3); reset by callers that count
LAUNCHES = 0
BATCHED_LAUNCHES = 0
NUMERIC_LAUNCHES = 0

LP_TILE = 128  # products per block; the table holds 2 * LP_TILE slots

# K3's size classes (kClasses in csrc/spgemm_lp.cu): the most table slots
# (L1 + L2) of each class whose tables sit in shared memory; rows with more
# slots have theirs in device memory
CLASS_SLOTS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
# lp_hash in csrc/spgemm_lp.cu: a key's home slot in a table of s slots is the
# top log2(s) bits of key * LP_HASH_MUL (mod 2^32)
LP_HASH_MUL = 2654435761
_CONSTS: dict = {}  # (device, l1_size) -> _consts


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


def l1_cutoff(l1_size: int) -> int:
    """The paper's 50% rule: the keys an L1 of ``l1_size`` slots takes."""
    return min(l1_size // 2, l1_size - 1)


def lp_table_slots(c_nnz: torch.Tensor, r_c: int, l1_size: int | None) -> torch.Tensor:
    """(m,) int64: the slots of each row's tables in K3 — s2, the next power
    of two >= 2 * c_nnz[i] (at least 8), and ``l1_size`` more (its L1, with
    s2 its L2) where c_nnz[i] is past the forced L1's cutoff; 0 for an empty
    row. The same formula as the kernel's."""
    cn = c_nnz.clamp(0, r_c).to(torch.int64)
    s2 = _next_pow2_tensor((2 * cn).clamp(min=8))
    if l1_size is not None:
        s2 = torch.where(cn > l1_cutoff(l1_size), s2 + l1_size, s2)
    return torch.where(cn > 0, s2, 0)


def lp_home_slot(keys: torch.Tensor, size: int) -> torch.Tensor:
    """The home slot of each key in a K3 table of ``size`` (a power of two)
    slots, as the kernel's lp_hash computes it."""
    bits = size.bit_length() - 1
    return ((keys.long() * LP_HASH_MUL) & 0xFFFFFFFF) >> (32 - bits)


@functools.lru_cache(maxsize=None)
def class_bounds(l1_size: int | None) -> tuple:
    """The largest c_nnz whose tables fit each of ``CLASS_SLOTS`` (0 where
    no row fits); a row's slots never shrink as c_nnz grows, so a row of
    c_nnz in (bounds[c - 1], bounds[c]] belongs to class c."""
    def slots(cn: int) -> int:  # lp_table_slots of one row, in Python ints
        s2 = _next_pow2(max(2 * cn, 8))
        if l1_size is not None and cn > l1_cutoff(l1_size):
            s2 += l1_size
        return s2 if cn > 0 else 0

    bounds, lo = [], 0
    for cap in CLASS_SLOTS:
        hi = 2**31 - 1
        while lo < hi:  # the largest cn in [lo, 2^31) whose slots fit cap
            mid = (lo + hi + 1) // 2
            if slots(mid) <= cap:
                lo = mid
            else:
                hi = mid - 1
        bounds.append(lo)
    return tuple(bounds)


def _consts(device, l1_size: int | None):
    """(the class bounds with a leading 0, the buckets of the classes) as
    int32 tensors on ``device``."""
    key = (device, l1_size)
    found = _CONSTS.get(key)
    if found is None:  # made once: a host-to-device copy waits for the stream
        found = _CONSTS[key] = (
            torch.tensor((0, *class_bounds(l1_size)), dtype=torch.int32, device=device),
            torch.arange(1, len(CLASS_SLOTS) + 2, dtype=torch.int32, device=device))
    return found


def _bucket(c_nnz: torch.Tensor, l1_size: int | None) -> torch.Tensor:
    """(m,) int32: 0 for an empty row, c + 1 for class c, len(CLASS_SLOTS) + 1
    past the shared-memory classes. By c_nnz as given: a row past rC, which
    the kernel clamps to rC, can only land in a larger class than it needs."""
    return torch.bucketize(c_nnz, _consts(c_nnz.device, l1_size)[0], out_int32=True)


def lp_row_class(c_nnz: torch.Tensor, l1_size: int | None) -> torch.Tensor:
    """(m,) int32: each row's K3 size class — the index of the first of
    ``CLASS_SLOTS`` that holds its ``lp_table_slots``, ``len(CLASS_SLOTS)``
    where its tables live in device memory, -1 for an empty row."""
    return _bucket(c_nnz, l1_size) - 1


def device_allotment(counts: torch.Tensor, l1_size: int | None):
    """(g_off, g_slots) of rows whose tables K3 keeps in device memory, sized
    by ``counts`` (each >= 1): row p gets slots [g_off[p], g_off[p + 1]),
    4 * count + 8, plus ``l1_size`` where the row spills, which is at least
    its ``lp_table_slots``; ``g_slots`` in all (one wait)."""
    allot = counts.to(torch.int64) * 4 + 8
    if l1_size is not None:
        allot += torch.where(counts > l1_cutoff(l1_size), l1_size, 0)
    g_off = torch.zeros(counts.shape[0] + 1, dtype=torch.int64, device=counts.device)
    torch.cumsum(allot, 0, out=g_off[1:])
    with span("host.read", site="device_allotment.g_slots"):
        # repro: allow[jit-boundary.host-sync] Queue 1 item 6 (c): K3's wait for its device-memory allotment, only where a row's table lives there
        g_slots = int(g_off[-1])
    return g_off, g_slots


def lp_bins(c_nnz: torch.Tensor, r_c: int, l1_size: int | None):
    """K3's row binning, on the device in four ops (on the card the host's
    dispatch of an op costs more than the op) and one wait, plus a second
    where rows need device-memory tables: (rows, class_rows, g_off, g_slots).
    ``rows`` (int64) holds the non-empty rows sorted by class (stable, so
    ascending within a class); ``class_rows`` (a list) the rows of each
    class, the device-memory class last; ``g_off`` and ``g_slots`` place
    that class's tables (``device_allotment`` of their c_nnz, clamped to
    r_c; None and 0 where there is no such row)."""
    bucket, order = torch.sort(_bucket(c_nnz, l1_size), stable=True)
    # where each class starts (bincount would wait for its max): the one wait
    with span("host.read", site="lp_bins.starts"):
        # repro: allow[jit-boundary.host-sync] Queue 1 item 6 (c): K3's wait for its class starts, which size the launch's grid
        starts = torch.searchsorted(bucket, _consts(c_nnz.device, l1_size)[1]).tolist()
    starts.append(c_nnz.shape[0])
    class_rows = [b - a for a, b in zip(starts, starts[1:])]
    g_off, g_slots = None, 0
    if class_rows[-1]:
        g_off, g_slots = device_allotment(c_nnz[order[starts[-2]:]].clamp(max=r_c), l1_size)
    return order[starts[0]:], class_rows, g_off, g_slots


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
    top = 0
    if b_idx.numel():
        with span("host.read", site="_column_bound.b_max"):
            # repro: allow[jit-boundary.host-sync] Queue 1 item 6 (c): two waits, only where the caller gives no k (kernels/ops always gives one)
            top = int(b_idx.max())
    if c_idx.numel():
        with span("host.read", site="_column_bound.c_max"):
            # repro: allow[jit-boundary.host-sync] Queue 1 item 6 (c), as above
            top = max(top, int(c_idx.max()))
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
    the L1 size of each row whose c_nnz is past its cutoff (those rows
    spill to L2); None sizes every row's one table so that it never spills.
    A structure may list fewer columns than a row's products reach: such
    rows are run again with tables sized by their products (one more wait
    on the card). ``k``: B's number of columns; a product whose
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
    out = torch.zeros(c_idx.shape, dtype=torch.float32, device=a_idx.device)
    rows, class_rows, g_off, g_slots = (lp_bins(c_nnz, c_idx.shape[1], l1_size)
                                        if out.numel() else (None, [0], None, 0))
    if sum(class_rows):
        ell = (a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz, out, k)
        lost = torch.empty(1, dtype=torch.int32, device=a_idx.device)  # zeroed by the launcher
        lost_rows = torch.empty(rows.shape[0], dtype=torch.int64, device=a_idx.device)
        launch_ell("spgemm_lp", *ell, l1_size=l1_size or 0, rows=rows,
                   class_rows=class_rows, g_off=g_off, g_tab=_table(g_slots, a_idx.device),
                   lost_count=lost, lost_rows=lost_rows)
        NUMERIC_LAUNCHES += 1
        with span("host.read", site="spgemm_lp.n_lost"):
            # repro: allow[jit-boundary.host-sync] Queue 1 item 6 (c): K3's wait for its count of lost rows, which decides the rerun
            n_lost = int(lost)  # the wait for the kernel's count of lost rows
        if n_lost:
            _redo_lost_rows(ell, lost_rows[:n_lost], l1_size)
    return out.to(torch.promote_types(a_val.dtype, b_val.dtype))


def _table(slots: int, device):
    """Device-memory tables of ``slots`` slots, a slot an int32 key beside
    its f32 value's bits (None for 0)."""
    return torch.empty(2 * slots, dtype=torch.int32, device=device) if slots else None


def _redo_lost_rows(ell, rows, l1_size) -> None:
    """Run K3 again on ``rows``, whose tables filled, in device-memory
    tables sized by each row's product count (which bounds its distinct
    keys, so no table fills), rewriting their outputs in ``out``."""
    global NUMERIC_LAUNCHES
    a_idx, a_val, a_nnz, b_idx, b_val, b_nnz, c_idx, c_nnz, out, k = ell
    n, r_a, r_b = b_idx.shape[0], a_idx.shape[1], b_idx.shape[1]
    live = torch.arange(r_a, device=rows.device) < a_nnz[rows].clamp(0, r_a)[:, None]
    widths = b_nnz[a_idx[rows].long().clamp(0, n - 1)].clamp(0, r_b)
    products = torch.where(live, widths, 0).sum(1).clamp(min=1)
    g_off, g_slots = device_allotment(products, l1_size)
    class_rows = [0] * len(CLASS_SLOTS) + [rows.shape[0]]
    launch_ell("spgemm_lp", *ell, l1_size=l1_size or 0, rows=rows, class_rows=class_rows,
               g_off=g_off, g_tab=_table(g_slots, rows.device), size_counts=products)
    NUMERIC_LAUNCHES += 1


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
    ``lp_reuse_plain``. seg_ids must be sorted, as a plan's are: the kernel
    gives wrong sums for unsorted ones and does not check.
    """
    global LAUNCHES
    check_replay_args(a_slot_s, b_slot_s, seg_ids, a_values, b_values, nnz_cap)
    if a_values.device.type == "cpu":
        return lp_reuse_plain(a_slot_s, b_slot_s, seg_ids, a_values, b_values,
                              nnz_cap)
    out = replay_out(seg_ids, nnz_cap, a_values.device)
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


def lp_reuse_batched_plain(a_slot_s, b_slot_s, seg_ids, a_values, b_values,
                           nnz_cap: int) -> torch.Tensor:
    """``lp_reuse_batched_arrays`` in plain torch (``replay_batched_plain``)."""
    return replay_batched_plain(a_slot_s, b_slot_s, seg_ids, a_values, b_values, nnz_cap)


def lp_reuse_batched_arrays(a_slot_s, b_slot_s, seg_ids, a_values, b_values, *,
                            nnz_cap: int) -> torch.Tensor:
    """One LP-table launch over stacked values: (batch, nnz_cap) C values,
    with the operand contract of ``segsum_reuse_batched_arrays``. CUDA
    tensors launch the kernel (or raise); CPU tensors run
    ``lp_reuse_batched_plain``."""
    global BATCHED_LAUNCHES
    check_replay_args(a_slot_s, b_slot_s, seg_ids, a_values, b_values, nnz_cap,
                      batched=True)
    if a_values.device.type == "cpu":
        return lp_reuse_batched_plain(a_slot_s, b_slot_s, seg_ids, a_values, b_values,
                                      nnz_cap)
    launched, out = run_batched("lp_reuse", a_slot_s, b_slot_s, seg_ids, a_values,
                                b_values, nnz_cap)
    BATCHED_LAUNCHES += launched
    return out


def lp_reuse_batched(plan, a_values, b_values) -> torch.Tensor:
    """Replay a ``SpgemmPlan`` over stacked values with K2's batched launch
    (``ReuseExecutor.apply_batched`` with ``backend="pallas_lp"`` on the
    card)."""
    return lp_reuse_batched_arrays(plan.a_slot_s, plan.b_slot_s, plan.seg_ids,
                                   a_values, b_values, nnz_cap=plan.indices.shape[0])
