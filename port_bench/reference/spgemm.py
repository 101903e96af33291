"""Plain reference for the operation "spgemm", C = A·B on CSR operands, in
torch, float64 by default.

A traffic mix names each product's operation (``op``); the harness finds its
reference as ``reference/<op>.py``, which gives ``compute(a, b, dtype,
with_scale)`` (C from the inputs) and ``work(a, b, c, batch)`` (the bytes and
flops of a numeric phase that any implementation of the operation must do,
for the kernels' rooflines).

``compute`` expands every product of the multiply (one per pair of an entry
a_ij of A and an entry b_jk of B's row j), keys it by (i, k), sorts the keys
and sums the products of each key. So C's structure is the symbolic one: an
entry for every (i, k) that some product reaches, kept even where its values
cancel, with columns sorted within a row. Beside the values it sums the
products of the absolute values, ``scale``, the yardstick against which a
value's error is measured, so that cancellation does not make a rounding
look large.

The rows are taken in blocks of at most ``block_products`` products, so the
expansion fits beside whatever else the device holds. ``dtype`` is the
precision of the products and sums: float64 for the reference; a lower one
(bfloat16) for the control, which must fail the benchmark's comparison.

Operands are the harness's CSR records (``indptr``, ``indices``, ``values``,
``shape``, ``scale``, ``nnz``); the answer is a record of the same type.
This module imports only torch and the yardstick: nothing of the program
under test.
"""
from __future__ import annotations

import torch

import pb_yardstick


def _abs_scale(x) -> torch.Tensor:
    if x.scale is not None:
        return x.scale
    return x.values[:x.nnz].double().abs()


def count_products(a, b) -> int:
    """The products of A·B: the sum over A's entries a_ij of nnz(B's row j)."""
    b_row_nnz = (b.indptr[1:] - b.indptr[:-1]).long()
    return int(b_row_nnz[a.indices[:a.nnz].long()].sum())


def _row_blocks(cum_at_rows: torch.Tensor, budget: int):
    """Split rows into consecutive blocks of at most ``budget`` products
    (a row with more products is a block of its own)."""
    cum = cum_at_rows.cpu()
    m = cum.shape[0] - 1
    r0 = 0
    while r0 < m:
        limit = int(cum[r0]) + budget
        r1 = int(torch.searchsorted(cum, torch.tensor(limit), right=True)) - 1
        r1 = min(max(r1, r0 + 1), m)
        yield r0, r1
        r0 = r1


def compute(a, b, dtype=torch.float64, with_scale: bool = True,
            block_products: int = 1 << 26):
    """C = A·B with products and sums in ``dtype``; ``scale`` in float64."""
    dev = a.indptr.device
    m, n = a.shape[0], b.shape[1]
    a_ip = a.indptr.long()
    b_ip = b.indptr.long()
    a_nnz, b_nnz = int(a_ip[-1]), int(b_ip[-1])
    a_idx = a.indices[:a_nnz].long()
    b_idx = b.indices[:b_nnz].long()
    a_val = a.values[:a_nnz].to(dtype)
    b_val = b.values[:b_nnz].to(dtype)
    a_abs = _abs_scale(a) if with_scale else None
    b_abs = _abs_scale(b) if with_scale else None
    a_row = torch.repeat_interleave(torch.arange(m, device=dev), a_ip.diff())
    per_entry = (b_ip[1:] - b_ip[:-1])[a_idx]
    cum = torch.zeros(a_nnz + 1, dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(per_entry, 0)
    keys, vals, scales = [], [], []
    for r0, r1 in _row_blocks(cum[a_ip], block_products):
        e0, e1 = int(a_ip[r0]), int(a_ip[r1])
        total = int(cum[e1] - cum[e0])
        if total == 0:
            continue
        ent = torch.repeat_interleave(torch.arange(e0, e1, device=dev), per_entry[e0:e1])
        within = torch.arange(total, device=dev) - (cum[ent] - cum[e0])
        b_pos = b_ip[a_idx[ent]] + within
        del within
        key = a_row[ent] * n + b_idx[b_pos]
        uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
        del key
        prod = a_val[ent] * b_val[b_pos]
        out = torch.zeros(uniq.shape[0], dtype=dtype, device=dev)
        vals.append(out.index_add_(0, inv, prod))
        if with_scale:
            s = torch.zeros(uniq.shape[0], dtype=torch.float64, device=dev)
            scales.append(s.index_add_(0, inv, a_abs[ent] * b_abs[b_pos]))
        keys.append(uniq)
        del ent, b_pos, inv, prod
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    key = torch.cat(keys) if keys else empty
    rows = torch.div(key, n, rounding_mode="floor")
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m), 0)
    return type(a)(indptr=indptr, indices=key - rows * n,
                   values=torch.cat(vals) if vals else torch.zeros(0, dtype=dtype, device=dev),
                   shape=(m, n),
                   scale=(torch.cat(scales) if scales else empty.double()) if with_scale else None)


def work(a, b, c, batch: int = 1) -> tuple[int, int]:
    """(bytes, flops) of the numeric phase of C = A·B on a fixed structure
    for ``batch`` value sets (``pb_yardstick.numeric_phase_work``)."""
    return pb_yardstick.numeric_phase_work(a.shape[0], a.nnz, b.shape[0], b.nnz, c.shape[0],
                                           c.nnz, count_products(a, b), batch=batch)
