"""Two-phase SpGEMM, sparse and LP methods (port of ``repro/core/spgemm.py``).

A fresh ``spgemm()`` runs the reference's single-expansion pipeline: one
``expand_products`` and one stable sort feed both the symbolic row counts
and the numeric ``SpgemmPlan``:

  ``expand_and_sort``  -> sorted products + row sizes
  host                 -> nnz(C), bucketed nnz_cap
  ``plan_from_sorted`` -> SpgemmPlan (precomposed slot maps, sentinel seg_ids)
  ``fresh_values``     -> C values: the CUDA segment-sum replay kernel K1 on
                          the card (``numeric_reuse``, plain torch, on the
                          CPU), or ``lp_replay_values`` -> the CUDA LP-hash
                          replay kernel for method="lp"

The plan arrays are bitwise equal to the reference's. Where the reference
relies on JAX semantics the port spells them out:

* the sort always packs ``(row, col)`` into one int64 key and sorts it
  stably, which gives exactly ``lexsort``'s order; the reference packs into
  int32 only while ``(m+1)*k < 2^31`` and otherwise runs a fused two-key sort;
* JAX gathers clamp out-of-range indices where torch raises, so every clamp
  of the expansion is explicit;
* JAX scatters drop the index ``nnz_cap`` (``mode="drop"``); ``numeric_reuse``
  adds into ``nnz_cap + 1`` slots and slices the last one off;
* C's structure comes from the boundaries of the sorted expansion, with no
  scatter, on both devices: a row's products are one run of the sorted rows
  (``searchsorted`` finds the runs), so its size is the heads counted across
  it on the prefix sum that also numbers the C slots (``seg_ids``), where the
  reference scatter-adds each head into its row; C's columns come from
  ``kernels.plan_columns``, on the card a CUDA kernel that stores each head's
  column once at its ``seg_ids`` slot, on the CPU the reference's
  scatter-max (``plan_columns_plain``), bit for bit the same;
* the product prefix sum runs in int64 and more than 2^31 - 1 products raise
  ``CapacityOverflowError``, where the reference's int32 sum would wrap.

The dense method (KKDENSE) runs the reference's host-mediated symbolic
phase (``symbolic``: the sort path over B, or over its bitmask-compressed
form when the CF <= 0.85 rule fires) and ``numeric_dense_acc``, a dense
(m, k) accumulator; it has no plan and no Reuse path. Where JAX's
``nonzero(size=nnz_cap, fill_value=0)`` returns a fixed size, the port cuts
or pads ``torch.nonzero``'s output to ``nnz_cap``.

On the card a fresh multiply's values come from K1 (``fresh_values``) where
the reference sums in f32: K1 adds in a fixed order, so the values repeat
bit for bit, where the plain ``index_add_``'s atomics add in another order
each run. On the CPU, and for operands the reference sums in another dtype
(bf16 x bf16, f16 x f16, f64, integers), it is the plain ``numeric_reuse``,
bitwise the reference's on the CPU.

``STAGE_COUNTS`` counts stage *calls*. It takes the place of the reference's
``TRACE_COUNTS``, which counts XLA retraces: eager PyTorch never retraces.

``spgemm`` takes the reference's robustness and selection options:
``validate=`` checks both operands with ``runtime.validate.check_csr``
before any dispatch, ``trace=`` pins the ``obs.trace`` mode for the call
(spans ``spgemm.prepare``, ``plan.build``, ``spgemm.symbolic`` and
``numeric.dispatch`` at the reference's places), and ``tune="measure"``
replays through the measured-fastest replay backend (``_measured_replay``).
``mesh=`` runs the multiply sharded over a ``repro_torch.compat`` mesh
through ``repro_torch.dist.sharded_spgemm`` (on the card each shard's
replay is a K1 launch).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import NamedTuple

import torch

from repro_torch.core.compression import (CompressedMatrix, compress_matrix,
                                          compression_decision, flops_stats)
from repro_torch.core.meta import (DEFAULT_PAD_POLICY, choose_kernel,
                                   choose_method, f32_accumulation_ok,
                                   round_capacity)
from repro_torch.core.plan_cache import default_plan_cache, structure_key
from repro_torch.core.utils import popcount, segment_ends, segmented_scan
from repro_torch.kernels.plan_columns import plan_columns
from repro_torch.kernels.segsum_reuse import segsum_reuse
from repro_torch.kernels.spgemm_lp import lp_reuse
from repro_torch.obs.trace import span, trace_scope
from repro_torch.runtime import ladder
from repro_torch.runtime.validate import CapacityOverflowError, SpgemmConfigError
from repro_torch.sparse.formats import CSR, ELL, csr_row_ids

INT32_MAX = 2**31 - 1

# Stage-call telemetry: every stage bumps its counter once per call.
STAGE_COUNTS: Counter = Counter()


def _note_stage(name: str) -> None:
    # repro: allow[telemetry-key.unknown-family] registered as the "trace" family: eager torch never retraces, so stage calls stand in for TRACE_COUNTS
    STAGE_COUNTS[name] += 1


def reset_stage_counts() -> None:
    STAGE_COUNTS.clear()


@dataclasses.dataclass(frozen=True)
class ProductExpansion:
    """Flattened multiplication space: product t multiplies A-slot
    ``a_slot[t]`` with B-slot ``b_slot[t]`` into C at (``row[t]``,
    ``col[t]``). ``valid`` masks padding (whose row is the sentinel m)."""

    row: torch.Tensor
    col: torch.Tensor
    a_slot: torch.Tensor
    b_slot: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SortedExpansion:
    """One expansion + one sort: everything both phases need."""

    order: torch.Tensor  # (fm_cap,) int32 — the single sort permutation
    rows_s: torch.Tensor  # (fm_cap,) int32 — rows in sorted order
    cols_s: torch.Tensor  # (fm_cap,) int32 — cols in sorted order
    valid_s: torch.Tensor  # (fm_cap,) bool — validity in sorted order
    heads: torch.Tensor  # (fm_cap,) bool — group heads (padding mints none)
    seg_ids: torch.Tensor  # (fm_cap,) int32 — sorted product -> C slot
    a_slot: torch.Tensor  # (fm_cap,) int32 — unsorted, from the expansion
    b_slot: torch.Tensor  # (fm_cap,) int32
    valid: torch.Tensor  # (fm_cap,) bool
    row_sizes: torch.Tensor  # (m,) int32 — the symbolic output


@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Numeric plan of the Reuse case (the reference's v2, precomposed).

    ``a_slot_s``/``b_slot_s`` are in sorted product order and padding
    products carry the sentinel ``seg_ids == nnz_cap``, so a replay is two
    gathers and one sorted segment-sum.
    """

    indptr: torch.Tensor  # (m+1,) int32 — C row pointers
    indices: torch.Tensor  # (nnz_cap,) int32 — C columns, sorted per row
    seg_ids: torch.Tensor  # (fm_cap,) int32 — sorted product -> C slot
    a_slot_s: torch.Tensor  # (fm_cap,) int32 — A slot per sorted product
    b_slot_s: torch.Tensor  # (fm_cap,) int32 — B slot per sorted product
    shape: tuple  # (m, k) of C


class SpgemmResult(NamedTuple):
    c: CSR
    plan: SpgemmPlan | None
    stats: dict


def _single_sort_order(rows: torch.Tensor, keys: torch.Tensor, m: int,
                       key_bound: int) -> torch.Tensor:
    """Stable sort permutation by (rows, keys) in ONE pass: exactly
    ``lexsort((keys, rows))``. Rows may carry the padding sentinel ``m``;
    keys must lie in [0, key_bound)."""
    if (m + 1) * key_bound > 2**63 - 1:
        raise CapacityOverflowError(
            f"(m+1)*key_bound = {(m + 1) * key_bound} does not fit the int64 "
            f"sort key")
    packed = rows.long() * key_bound + keys.long()
    return torch.sort(packed, stable=True).indices.to(torch.int32)


def _check_fm(fm: int) -> None:
    if fm > INT32_MAX:
        raise CapacityOverflowError(
            f"{fm} products exceed the int32 plan arrays (at most "
            f"{INT32_MAX}); split the multiply")


def expand_products(a: CSR, b: CSR, fm_cap: int) -> ProductExpansion:
    """Enumerate all f_m multiplications with static capacity ``fm_cap``.

    For product t: binary-search the owning A-slot in the exclusive prefix of
    per-A-slot product counts, then offset into B's row.
    """
    _note_stage("expand_products")
    _check_fm(fm_cap)
    dev = a.device
    b_row_nnz = b.row_nnz()
    per_slot = torch.where(a.valid_mask(),
                           b_row_nnz[a.indices.clamp(0, b.m - 1).long()], 0)
    offsets = torch.zeros(a.nnz_cap + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(per_slot, 0, dtype=torch.int64)
    t = torch.arange(fm_cap, dtype=torch.int64, device=dev)
    a_slot = (torch.searchsorted(offsets, t, right=True) - 1).clamp_(0, a.nnz_cap - 1)
    within = t - offsets[a_slot]
    valid = t < offsets[-1]
    del t
    j = a.indices[a_slot].clamp(0, b.m - 1).long()
    b_slot = (b.indptr[j].long() + within).clamp_(0, b.nnz_cap - 1)
    del j, within
    rows = csr_row_ids(a.indptr, a.nnz_cap)[a_slot]
    col = b.indices[b_slot]
    return ProductExpansion(
        row=torch.where(valid, rows, a.m),  # pad rows to m -> sort to the end
        col=torch.where(valid, col, 0),
        a_slot=a_slot.to(torch.int32),
        b_slot=b_slot.to(torch.int32),
        valid=valid,
    )


def _row_sizes_from_bounds(rows_s: torch.Tensor, seen: torch.Tensor, m: int) -> torch.Tensor:
    """(m,) int32 distinct columns per row of a sorted expansion, with no
    atomics: row r's products are the run ``[starts[r], starts[r+1])`` of
    ``rows_s`` (padding carries row m and sorts last, so ``starts[m]`` is the
    live count), and its size is the heads counted across the run, read off
    ``seen``, the heads' inclusive prefix sum."""
    if seen.numel() == 0:
        return torch.zeros(m, dtype=torch.int32, device=rows_s.device)
    bounds = torch.arange(m + 1, dtype=rows_s.dtype, device=rows_s.device)
    starts = torch.searchsorted(rows_s, bounds)
    before = torch.where(starts > 0, seen[(starts - 1).clamp_(min=0)], 0)
    return before[1:] - before[:-1]


def expand_and_sort(a: CSR, b: CSR, fm_cap: int) -> SortedExpansion:
    """The fused front half of a fresh multiply: ONE expansion, ONE sort.
    Returns sorted products plus per-row distinct-column counts."""
    _note_stage("expand_and_sort")
    ex = expand_products(a, b, fm_cap)
    order = _single_sort_order(ex.row, ex.col, a.m, b.k)
    rows_s = ex.row[order]
    cols_s = ex.col[order]
    valid_s = ex.valid[order]
    heads = torch.ones_like(valid_s)
    heads[1:] = (rows_s[1:] != rows_s[:-1]) | (cols_s[1:] != cols_s[:-1])
    heads &= valid_s  # padding (row == m) groups don't mint slots
    seen = torch.cumsum(heads, 0, dtype=torch.int32)  # heads up to and at i
    row_sizes = _row_sizes_from_bounds(rows_s, seen, a.m)
    seg_ids = seen.sub_(1).clamp_(min=0)
    return SortedExpansion(order=order, rows_s=rows_s, cols_s=cols_s,
                           valid_s=valid_s, heads=heads, seg_ids=seg_ids,
                           a_slot=ex.a_slot, b_slot=ex.b_slot, valid=ex.valid,
                           row_sizes=row_sizes)


def plan_from_sorted(sx: SortedExpansion, k: int, nnz_cap: int) -> SpgemmPlan:
    """Back half of a fresh multiply: C structure + reuse plan, no re-sort.
    Precomposes the sort permutation into the slot maps."""
    _note_stage("plan_from_sorted")
    m = sx.row_sizes.shape[0]
    indptr = torch.zeros(m + 1, dtype=torch.int32, device=sx.seg_ids.device)
    indptr[1:] = torch.cumsum(sx.row_sizes, 0, dtype=torch.int32)
    return SpgemmPlan(
        indptr=indptr,
        indices=plan_columns(sx.heads, sx.seg_ids, sx.cols_s, nnz_cap),
        seg_ids=torch.where(sx.valid_s, sx.seg_ids, nnz_cap).to(torch.int32),
        a_slot_s=sx.a_slot[sx.order],
        b_slot_s=sx.b_slot[sx.order],
        shape=(m, k),
    )


def host_fm_cap(a: CSR, b: CSR, pad_to: int = 8, fm: int | None = None) -> int:
    """Host-side f_m (total products) rounded up to a multiple of ``pad_to``."""
    if fm is None:
        with span("host.read", site="host_fm_cap.fm"):
            fm = int(flops_stats(a, b.row_nnz())[0])
    return max(-(-fm // pad_to) * pad_to, pad_to)


# --------------------------------------------------------------------------
# Symbolic phase
# --------------------------------------------------------------------------


def _symbolic_sorted(rows, keys, payload, valid, m: int, fm_cap: int,
                     key_bound: int | None) -> torch.Tensor:
    """Shared core: sort (row, key) pairs, OR payloads per group, count the
    set bits of each group per row (plain symbolic: payload 1 per product).
    ``key_bound`` None takes one past the largest key."""
    _note_stage("_symbolic_sorted")
    if key_bound is None and keys.numel():
        with span("host.read", site="_symbolic_sorted.key_bound"):
            key_bound = int(keys.max()) + 1
    elif key_bound is None:
        key_bound = 1
    order = _single_sort_order(rows, keys, m, max(key_bound, 1))
    rows_s, keys_s, valid_s = rows[order], keys[order], valid[order]
    pay_s = payload[order]
    heads = torch.ones_like(valid_s)
    heads[1:] = (rows_s[1:] != rows_s[:-1]) | (keys_s[1:] != keys_s[:-1])
    or_scan = segmented_scan(pay_s, heads, torch.bitwise_or)
    ends = segment_ends(heads) & valid_s
    contrib = torch.where(ends, popcount(or_scan), 0)
    sizes = torch.zeros(m, dtype=torch.int32, device=rows.device)
    sizes.index_add_(0, rows_s.clamp(max=m - 1).long(), contrib)
    return sizes


def _per_slot(a: CSR, row_nnz: torch.Tensor, nb: int) -> torch.Tensor:
    return torch.where(a.valid_mask(), row_nnz[a.indices.clamp(0, nb - 1).long()], 0)


def symbolic_compressed(a: CSR, bc: CompressedMatrix, m: int, fm_cap: int,
                        key_bound: int | None = None) -> torch.Tensor:
    """Symbolic phase on the compressed B (paper §3.2): expand (row, CSI, CS)
    products, OR the CS masks per (row, CSI), sum popcounts per row.
    key_bound: bound on CSI values (ceil(k/32)); None takes the largest."""
    _note_stage("symbolic_compressed")
    _check_fm(fm_cap)
    dev = a.device
    nb = bc.indptr.shape[0] - 1
    offsets = torch.zeros(a.nnz_cap + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(_per_slot(a, bc.row_nnz(), nb), 0)
    t = torch.arange(fm_cap, dtype=torch.int64, device=dev)
    a_slot = (torch.searchsorted(offsets, t, right=True) - 1).clamp_(0, a.nnz_cap - 1)
    within = t - offsets[a_slot]
    valid = t < offsets[-1]
    del t
    j = a.indices[a_slot].clamp(0, nb - 1).long()
    cap = bc.csi.shape[0]
    b_slot = (bc.indptr[j].long() + within).clamp_(0, cap - 1)
    rows = torch.where(valid, csr_row_ids(a.indptr, a.nnz_cap)[a_slot], m)
    keys = torch.where(valid, bc.csi[b_slot], 0)
    cs = torch.where(valid, bc.cs[b_slot], 0)
    return _symbolic_sorted(rows, keys, cs, valid, m, fm_cap, key_bound)


def symbolic_plain(a: CSR, b: CSR, fm_cap: int) -> torch.Tensor:
    """Uncompressed symbolic: distinct-column count per row via sort."""
    _note_stage("symbolic_plain")
    ex = expand_products(a, b, fm_cap)
    ones = ex.valid.to(torch.int32)
    return _symbolic_sorted(ex.row, ex.col, ones, ex.valid, a.m, fm_cap,
                            key_bound=max(b.k, 1))


def symbolic_dense_bitmask(a_ell: ELL, b_bitmask: torch.Tensor,
                           block_rows: int = 64) -> torch.Tensor:
    """KKDENSE symbolic: per row block, OR B's bitmask rows that A's ELL row
    selects into a dense (rows, ceil(k/32)) accumulator and count its bits —
    the dense-accumulator symbolic with 32x compression, in plain torch (the
    function of kernel K5, ``kernels.spgemm_symbolic``). ``block_rows`` is
    the reference's memory knob; the port chunks by its own word budget and
    gives the same sizes for every value."""
    from repro_torch.kernels.spgemm_symbolic import spgemm_symbolic_plain

    del block_rows
    return spgemm_symbolic_plain(a_ell.indices, a_ell.row_nnz, b_bitmask)


def symbolic(a: CSR, b: CSR, compress: str = "auto",
             pad_policy: str = DEFAULT_PAD_POLICY):
    """Paper Alg. 2 lines 1-3. Returns (row_sizes, stats). Host-mediated:
    decides compression by the CF <= 0.85 rule and sizes the expansion.
    compress: "auto" (the rule), "always", or anything else for never."""
    stats: dict = {}
    fm, maxrf = _fm_scalars(a, b)
    stats["fm"] = fm
    stats["maxrf"] = maxrf
    use_c = False
    cf = cmrf = 1.0
    bc = None
    if compress in ("auto", "always"):
        bc = compress_matrix(b)
        cf, cmrf, use_c = compression_decision(a, b, bc)
        if compress == "always":
            use_c = True
    stats["cf"], stats["cmrf"], stats["compressed"] = cf, cmrf, use_c
    if use_c and bc is not None:
        with span("host.read", site="symbolic.fm_c"):
            fm_c = max(int(_per_slot(a, bc.row_nnz(), bc.indptr.shape[0] - 1).sum()), 1)
        cap = round_capacity(fm_c, pad_policy)
        sizes = symbolic_compressed(a, bc, a.m, cap, key_bound=-(-b.k // 32))
    else:
        cap = round_capacity(fm, pad_policy)
        sizes = symbolic_plain(a, b, cap)
    return sizes, stats


# --------------------------------------------------------------------------
# Numeric phase
# --------------------------------------------------------------------------


def numeric_fresh(a: CSR, b: CSR, fm_cap: int, nnz_cap: int):
    """First numeric run: discovers C's structure and the product->slot map,
    computes values (``fresh_values``: K1 on the card). Returns (CSR C,
    SpgemmPlan)."""
    _note_stage("numeric_fresh")
    sx = expand_and_sort(a, b, fm_cap)
    plan = plan_from_sorted(sx, b.k, nnz_cap)
    del sx
    values, _ = fresh_values(plan, a.values, b.values)
    c = CSR(indptr=plan.indptr, indices=plan.indices, values=values, shape=(a.m, b.k))
    return c, plan


def numeric_lp(a: CSR, b: CSR, fm_cap: int, nnz_cap: int):
    """KKLP-position numeric phase: structure via the single-expansion
    pipeline, values through the LP-hash replay kernel K2 (``lp_reuse``;
    f64/int operands take the plain replay). Returns (CSR C, SpgemmPlan),
    the contract of ``numeric_fresh``."""
    _note_stage("numeric_lp")
    sx = expand_and_sort(a, b, fm_cap)
    plan = plan_from_sorted(sx, b.k, nnz_cap)
    del sx
    values, _ = lp_replay_values(plan, a.values, b.values)
    c = CSR(indptr=plan.indptr, indices=plan.indices, values=values, shape=(a.m, b.k))
    return c, plan


def numeric_dense_acc(a: CSR, b: CSR, fm_cap: int, nnz_cap: int) -> CSR:
    """KKDENSE numeric: scatter all products into a dense (m, k) accumulator
    in A's dtype, then extract the CSR structure in row-major order, cut or
    padded to ``nnz_cap`` slots. The structure comes from the products that
    exist, not from values != 0 (a cancelled sum keeps its explicit zero).
    O(m*k) memory: the paper's dense-accumulator trade-off. The occupancy
    mask is bool here, where the reference keeps int32."""
    _note_stage("numeric_dense_acc")
    m, k = a.m, b.k
    dev = a.device
    ex = expand_products(a, b, fm_cap)
    acc = torch.promote_types(a.values.dtype, b.values.dtype)
    vals = torch.where(ex.valid, a.values[ex.a_slot.long()].to(acc)
                       * b.values[ex.b_slot.long()].to(acc), 0)
    flat = ex.row.clamp(max=m - 1).long() * k + ex.col.long()
    dense = torch.zeros(m * k, dtype=a.values.dtype, device=dev)
    dense.index_add_(0, flat, vals.to(a.values.dtype))
    occupied = torch.zeros(m * k, dtype=torch.bool, device=dev)
    occupied[flat[ex.valid]] = True
    del ex, vals, flat
    pos = torch.nonzero(occupied).flatten()  # row-major, as jnp.nonzero
    nnz = pos.shape[0]
    keep = min(nnz, nnz_cap)
    indices = torch.zeros(nnz_cap, dtype=torch.int32, device=dev)
    values = torch.zeros(nnz_cap, dtype=a.values.dtype, device=dev)
    indices[:keep] = (pos[:keep] % k).to(torch.int32)
    values[:keep] = dense[pos[:keep]]
    row_sizes = occupied.view(m, k).sum(1)
    indptr = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(row_sizes, 0)
    return CSR(indptr=indptr, indices=indices, values=values, shape=(m, k))


def gather_clamped(values: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``values[..., slots]`` with the slots clamped into the buffer, as JAX
    gathers clamp: padding products may point past a caller's buffer when
    it holds only the live prefix of the plan's repadded operand."""
    return values.index_select(-1, slots.clamp(0, values.shape[-1] - 1))


def numeric_reuse(plan: SpgemmPlan, a_values: torch.Tensor,
                  b_values: torch.Tensor) -> torch.Tensor:
    """The Reuse case: same structure, new values. Two gathers + one sorted
    segment-sum, in plain torch.

    Slots clamp into the value buffers. Accumulates in
    ``torch.promote_types(a, b)`` like the reference (bf16 x bf16 accumulates
    in bf16). The sentinel ``seg_ids == nnz_cap`` lands in an extra output
    slot that is sliced off.
    """
    _note_stage("numeric_reuse")
    acc_dtype = torch.promote_types(a_values.dtype, b_values.dtype)
    prod = (gather_clamped(a_values, plan.a_slot_s).to(acc_dtype)
            * gather_clamped(b_values, plan.b_slot_s).to(acc_dtype))
    nnz_cap = plan.indices.shape[0]
    out = torch.zeros(nnz_cap + 1, dtype=acc_dtype, device=prod.device)
    out.index_add_(0, plan.seg_ids, prod)
    return out[:nnz_cap]


# a fresh multiply's rungs on the card: K1, then K2 if K1's launch fails
FRESH_RUNGS = ("pallas", "pallas_lp")


def fresh_backend(a_values: torch.Tensor, b_values: torch.Tensor) -> str:
    """What sums a fresh multiply's values, and a default ("auto") replay's
    (``core.executor.auto_backend``): "pallas" (K1) for CUDA operands that
    ``f32_accumulation_ok`` admits and that the reference sums in f32
    (``promote_types`` float32), else "xla", the plain ``numeric_reuse``:
    on the CPU, for bf16 x bf16 and f16 x f16 (the reference sums them in
    their own dtype), and for f64 and integer operands."""
    if (ladder.kernels_only(a_values.device)
            and f32_accumulation_ok(a_values.dtype, b_values.dtype)
            and torch.promote_types(a_values.dtype, b_values.dtype) == torch.float32):
        return "pallas"
    return "xla"


def fresh_values(plan: SpgemmPlan, a_values: torch.Tensor, b_values: torch.Tensor,
                 sp=None) -> tuple[torch.Tensor, str]:
    """The numeric phase of a fresh multiply on its just-built plan; returns
    (values, the backend that gave them). K1 (``segsum_reuse``) under the
    card's ladder (``runtime.ladder.walk``: a failed launch or an armed
    ``kernel:pallas`` steps to K2, never to the plain version; a library
    that cannot be built raises ``KernelFallbackError``) where
    ``fresh_backend`` says "pallas"; the plain ``numeric_reuse`` elsewhere.
    CUDA operands the dtype guard refuses bump
    ``FALLBACK_COUNTS["dtype:fresh->xla"]``. ``sp``: the caller's span,
    which gets the ladder's step as ``fallback``."""
    if fresh_backend(a_values, b_values) == "xla":
        if ladder.kernels_only(a_values.device) and not f32_accumulation_ok(
                a_values.dtype, b_values.dtype):
            from repro_torch.core.telemetry import FALLBACK_COUNTS  # cycle-free

            FALLBACK_COUNTS["dtype:fresh->xla"] += 1
        return numeric_reuse(plan, a_values, b_values), "xla"
    kernels = {"pallas": segsum_reuse, "pallas_lp": lp_reuse}
    return ladder.walk(FRESH_RUNGS, lambda name: kernels[name](plan, a_values, b_values),
                       on_kernel_failure="fallback", site="spgemm",
                       what="fresh numeric kernel",
                       on_step=None if sp is None else (lambda step: sp.set("fallback", step)))


def lp_replay_values(plan: SpgemmPlan, a_values: torch.Tensor,
                     b_values: torch.Tensor):
    """The one LP-position replay dispatch: the CUDA LP-hash kernel when the
    operand dtypes can accumulate in f32, the plain ``numeric_reuse``
    otherwise (f64/int). Returns (values, backend) with backend in
    {"pallas", "xla"}, the reference's names (see ``kernels.BACKEND_NAMES``).
    """
    if f32_accumulation_ok(a_values.dtype, b_values.dtype):
        return lp_reuse(plan, a_values, b_values), "pallas"
    return numeric_reuse(plan, a_values, b_values), "xla"


def _repad_csr(a: CSR, nnz_cap: int) -> CSR:
    """Re-pad a CSR's buffer capacity to a bucketed cap (live prefix kept).

    Requires nnz(a) <= nnz_cap. Runs on the matrix's device: only the nnz
    scalar comes to the host, never the values.
    """
    if nnz_cap == a.nnz_cap:
        return a
    with span("host.read", site="_repad_csr.nnz"):
        nnz = int(a.indptr[-1])
    if nnz > nnz_cap:
        raise CapacityOverflowError(
            f"cannot repad CSR to nnz_cap={nnz_cap}: {nnz} live entries would "
            f"be truncated (buffer cap {a.nnz_cap})")
    keep = min(nnz_cap, a.nnz_cap)
    indices = torch.zeros(nnz_cap, dtype=torch.int32, device=a.device)
    values = torch.zeros(nnz_cap, dtype=a.values.dtype, device=a.device)
    indices[:keep] = a.indices[:keep]
    values[:keep] = a.values[:keep]
    return CSR(indptr=a.indptr, indices=indices, values=values, shape=a.shape)


def _fm_scalars(a: CSR, b: CSR) -> tuple[int, int]:
    fm, _, maxrf = flops_stats(a, b.row_nnz())
    with span("host.read", site="_fm_scalars.fm"):
        fm = int(fm)
    with span("host.read", site="_fm_scalars.maxrf"):
        maxrf = int(maxrf)
    return fm, maxrf


def prepare_sparse_inputs(a: CSR, b: CSR, policy: str):
    """Bucket the operand buffer caps and size the expansion: the shared
    preamble of ``spgemm()`` and ``executor.spgemm_grouped``, so the inputs
    of ``structure_key`` cannot drift between them.
    Returns (a, b, fm, maxrf, fm_cap)."""
    with span("host.read", site="prepare_sparse_inputs.nnz_a"):
        nnz_a = int(a.indptr[-1])
    a = _repad_csr(a, round_capacity(max(nnz_a, 1), policy))
    with span("host.read", site="prepare_sparse_inputs.nnz_b"):
        nnz_b = int(b.indptr[-1])
    b = _repad_csr(b, round_capacity(max(nnz_b, 1), policy))
    fm, maxrf = _fm_scalars(a, b)
    _check_fm(fm)
    return a, b, fm, maxrf, round_capacity(fm, policy)


def resolve_plan(a: CSR, b: CSR, fm_cap: int, policy: str, cache, key=None):
    """Get-or-build the numeric plan for (repadded) A, B — the one place
    that keys, sizes and caches plans. ``key`` lets a caller that already
    hashed the structure skip the second digest.
    Returns (plan, cache_state, key) with cache_state in {"hit", "miss",
    "bypass"}."""
    if key is None:
        key = structure_key(a, b, fm_cap, policy)
    if cache is not None:
        plan = cache.get(key)
        if plan is not None:
            return plan, "hit", key
    with span("plan.build", structure_key=key, fm_cap=fm_cap) as sp:
        sx = expand_and_sort(a, b, fm_cap)
        with span("host.read", site="resolve_plan.nnz"):
            nnz = int(sx.row_sizes.sum())
        nnz_cap = round_capacity(nnz, policy)
        sp.set("nnz_cap", nnz_cap)
        plan = plan_from_sorted(sx, b.k, nnz_cap)
        del sx
    if cache is None:
        return plan, "bypass", key
    cache.put(key, plan)
    return plan, "miss", key


def _measured_replay(plan, a: CSR, b: CSR, cache, cache_key: str):
    """tune="measure" replay: dispatch the measured-fastest replay backend
    (``executor.measured_replay_backend``: plan-cache meta, then bucket,
    then micro-bench)."""
    from repro_torch.core.executor import _replay, measured_replay_backend

    winner = measured_replay_backend(plan, a.values, b.values, cache, cache_key)
    return _replay(plan, a.values, b.values, winner), winner


def spgemm(a: CSR, b: CSR, method: str = "auto", compress: str = "auto",
           pad_policy: str | None = None, plan_cache=None,
           tune: str | None = None, mesh=None, mesh_axis: str = "data",
           b_placement: str = "replicated",
           validate: str | None = None,
           trace: str | bool | None = None) -> SpgemmResult:
    """Full two-phase SpGEMM with the KKSPGEMM meta-algorithm's method choice.

    Runs where the operands' tensors live. ``method``: "sparse" (values from
    ``fresh_values``: K1 on the card, plain torch on the CPU), "lp" (values
    from the CUDA LP-hash replay kernel; f64/int operands take the plain
    path and bump ``FALLBACK_COUNTS["dtype:lp->xla"]``), "dense" (KKDENSE:
    ``symbolic`` and the dense (m, k) accumulator of ``numeric_dense_acc``,
    plain torch, ``plan=None``) or "auto" (``choose_method``: dense when k < 250,000 — or the fitted
    cutoff — and the accumulator fits 1 GiB).

    compress: only the dense method's symbolic phase reads it ("auto" = the
        paper's CF <= 0.85 rule, "always", or "never"); its stats (cf, cmrf,
        compressed) are only present on the dense path.

    pad_policy: capacity bucketing for every static cap ("pow2" default).
    plan_cache: None uses the module-level LRU; a PlanCache isolates; False
        disables caching for this call. On a structure hit the expansion and
        sort are skipped (stats["cache"] == "hit").
    validate: "off" (default via None) | "host" | "device" — typed operand
        validation (``runtime.validate.check_csr``) before any dispatch;
        ``None`` defers to ``$REPRO_VALIDATE``. "off" adds no work.
    tune: None or "measure" (sparse/auto-sparse only): the replay backend is
        the measured winner (``_measured_replay``), ``stats["kernel_source"]
        == "measured"`` and ``stats["replay_backend"]`` records it; the
        dense method ignores tune, method="lp" rejects it.
    trace: None (the ambient mode, ultimately ``$REPRO_TRACE``) | bool |
        "off" | "on" | "xprof" — phase spans for this call (``obs.trace``).
    mesh: a ``repro_torch.compat.Mesh``, or None for one device. With a
        mesh, A's rows are 1-D partitioned over ``mesh_axis``, the sharded
        plan comes from the mesh-aware cache (``repro_torch.dist``) and is
        replayed once a shard; ``b_placement`` picks "replicated" or
        "allgather". Sparse method only; ``tune=`` is not supported.
    """
    from repro_torch.core import autotune  # cycle-free
    from repro_torch.runtime.validate import check_csr, resolve_mode

    if trace is not None:
        # pin the mode for the whole call, then run the body under it
        with trace_scope(trace):
            return spgemm(a, b, method=method, compress=compress,
                          pad_policy=pad_policy, plan_cache=plan_cache,
                          tune=tune, mesh=mesh, mesh_axis=mesh_axis,
                          b_placement=b_placement, validate=validate, trace=None)
    policy = DEFAULT_PAD_POLICY if pad_policy is None else pad_policy
    if method not in ("auto", "dense", "sparse", "lp"):
        raise SpgemmConfigError(
            f"unknown method {method!r}; expected 'auto', 'dense', 'sparse' "
            f"or 'lp'")
    autotune.validate_tune(tune)
    vmode = resolve_mode(validate)
    if vmode != "off":
        check_csr(a, vmode, name="A")
        check_csr(b, vmode, name="B")
    if tune == "measure" and method == "lp":
        raise SpgemmConfigError(
            "tune='measure' does not compose with method='lp': 'lp' pins "
            "the LP-hash kernel explicitly, while measure mode exists to "
            "pick the replay backend empirically — use method='sparse' (or "
            "'auto') with tune='measure'")
    if mesh is not None:
        from repro_torch.compat import Mesh  # cycle-free

        if not isinstance(mesh, Mesh):
            raise SpgemmConfigError(
                f"mesh must be a repro_torch.compat.Mesh (compat.make_mesh), got "
                f"{type(mesh).__name__}")
        if tune is not None:
            raise SpgemmConfigError(
                "tune= does not support mesh= yet: the sharded replay has one "
                "path a shard (K1 on the card, the plain replay on the CPU), so "
                "there are no per-shard candidates to measure")
        if method == "dense":
            raise SpgemmConfigError(
                "mesh= requires the sparse method: KKDENSE has no "
                "product->slot map, so it cannot pin a sharded plan")
        if method == "lp":
            raise SpgemmConfigError(
                "mesh= does not support method='lp' yet: the sharded replay "
                "runs the segment sum (K1) only; use method='sparse' on a mesh")
        from repro_torch.dist import sharded_spgemm  # cycle-free late import

        return sharded_spgemm(a, b, mesh, axis=mesh_axis, b_placement=b_placement,
                              pad_policy=policy, plan_cache=plan_cache)
    stats: dict = {"pad_policy": policy, "validate": vmode}
    if method == "auto":
        method = choose_method(a, b, stats)
    stats["method"] = method
    if method == "dense":
        with span("spgemm.symbolic", method="dense"):
            sizes, sym_stats = symbolic(a, b, compress=compress, pad_policy=policy)
        stats.update(sym_stats)
        stats["kernel"] = choose_kernel(a, b, stats)  # advisory telemetry
        fm_cap = round_capacity(sym_stats["fm"], policy)
        stats["fm_cap"] = fm_cap
        with span("host.read", site="spgemm.dense_nnz"):
            nnz = int(sizes.sum())
        nnz_cap = round_capacity(nnz, policy)
        stats["nnz_c"] = nnz
        stats["nnz_cap"] = nnz_cap
        stats["cache"] = "bypass"
        with span("numeric.dispatch", kernel="dense_acc", method="dense"):
            c = numeric_dense_acc(a, b, fm_cap, nnz_cap)
        return SpgemmResult(c=c, plan=None, stats=stats)

    if plan_cache is None:
        cache = default_plan_cache()
    elif plan_cache is False:
        cache = None
    else:
        cache = plan_cache
    with span("spgemm.prepare", pad_policy=policy):
        a, b, fm, maxrf, fm_cap = prepare_sparse_inputs(a, b, policy)
    stats["fm"] = fm
    stats["maxrf"] = maxrf
    stats["fm_cap"] = fm_cap
    stats["kernel"] = choose_kernel(a, b, stats)  # the paper's GPU rule

    plan, cache_state, skey = resolve_plan(a, b, fm_cap, policy, cache)
    stats["structure_key"] = skey
    if method == "lp":
        with span("numeric.dispatch", method="lp") as sp:
            values, stats["lp_backend"] = lp_replay_values(plan, a.values, b.values)
            sp.set("kernel", stats["lp_backend"])
        stats["replay_backend"] = stats["lp_backend"]
        if stats["lp_backend"] == "xla":
            from repro_torch.core.telemetry import FALLBACK_COUNTS

            FALLBACK_COUNTS["dtype:lp->xla"] += 1
    elif tune == "measure":
        with span("numeric.dispatch", method="measure") as sp:
            values, winner = _measured_replay(plan, a, b, cache, skey)
            sp.set("kernel", winner)
        stats["replay_backend"] = winner
        stats["kernel_source"] = "measured"  # overrides choose_kernel's
    else:
        with span("numeric.dispatch", kernel=fresh_backend(a.values, b.values),
                  method=method) as sp:
            values, stats["replay_backend"] = fresh_values(plan, a.values, b.values, sp)
    c = CSR(indptr=plan.indptr, indices=plan.indices, values=values,
            shape=(a.m, b.k))
    stats["cache"] = cache_state
    with span("host.read", site="spgemm.nnz_c"):
        stats["nnz_c"] = int(plan.indptr[-1])
    stats["nnz_cap"] = plan.indices.shape[0]
    return SpgemmResult(c=c, plan=plan, stats=stats)
