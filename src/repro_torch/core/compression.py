"""Matrix compression for the symbolic phase (port of ``repro/core/compression.py``).

The graph of B is binary, so 32 columns pack into one 32-bit word: a row's
columns become (CSI = col >> 5, CS = 1 << (col & 31)) pairs, merged per CSI
with bitwise OR. The paper's rule: compress only when CF <= 0.85 (at least a
15% flop reduction); the constant is kept verbatim.

The words are int32 tensors with the reference's uint32 bits (bit 31 is the
sign bit): compare them with JAX's arrays through ``ndarray.view(np.uint32)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.utils import bit_of, popcount, segment_ends, segmented_scan
from repro_torch.obs.trace import span
from repro_torch.sparse.formats import CSR, csr_row_ids

COMPRESSION_CF_CUTOFF = 0.85  # paper §3.2: apply compression iff CF <= 0.85
BITS = 32


class CompressedMatrix(NamedTuple):
    """B_c: CSR over (row, CSI) with OR-merged CS bitmask payloads."""

    indptr: torch.Tensor  # (m+1,) int32
    csi: torch.Tensor  # (nnz_cap,) int32 — column-set index (col >> 5)
    cs: torch.Tensor  # (nnz_cap,) int32 — column-set bitmask (uint32 bits)
    shape: tuple  # (m, k) of the *original* matrix

    @property
    def k_compressed(self) -> int:
        return -(-self.shape[1] // BITS)

    def row_nnz(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]


def compress_matrix(b: CSR, nnz_cap: int | None = None) -> CompressedMatrix:
    """Build B_c. Output capacity defaults to B's (compression never grows).

    Entries of a row are grouped by CSI through one stable sort of the
    packed (row, CSI) key (``lexsort``'s order) and OR-merged by the
    segmented scan. The group representatives come first, in (row, CSI)
    order; the remaining slots hold 0, as in the reference.
    """
    cap = b.nnz_cap if nnz_cap is None else nnz_cap
    m, k32 = b.m, max(-(-b.k // BITS), 1)
    dev = b.device
    rows = csr_row_ids(b.indptr, b.nnz_cap)
    valid = b.valid_mask()
    csi = torch.where(valid, b.indices >> 5, 0)
    cs = bit_of(b.indices)
    sort_rows = torch.where(valid, rows, m + 1)  # padding sorts to the end
    order = torch.sort(sort_rows.long() * k32 + csi.long(), stable=True).indices
    rows_s, csi_s, cs_s, valid_s = sort_rows[order], csi[order], cs[order], valid[order]
    heads = torch.ones_like(valid_s)
    heads[1:] = (rows_s[1:] != rows_s[:-1]) | (csi_s[1:] != csi_s[:-1])
    or_scan = segmented_scan(cs_s, heads, torch.bitwise_or)
    ends = segment_ends(heads) & valid_s
    pos = torch.nonzero(ends).flatten()
    n_groups = pos.shape[0]
    out_csi = torch.zeros(cap, dtype=torch.int32, device=dev)
    out_cs = torch.zeros(cap, dtype=torch.int32, device=dev)
    out_csi[:n_groups] = csi_s[pos]
    out_cs[:n_groups] = or_scan[pos]
    counts = torch.bincount(rows_s[pos].long(), minlength=m)[:m]
    indptr = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(counts, 0)
    return CompressedMatrix(indptr=indptr, csi=out_csi, cs=out_cs, shape=b.shape)


def flops_stats(a: CSR, b_row_nnz: torch.Tensor):
    """(f_m total, per-row flops, MAXRF) for C = A*B given B's row sizes.

    Counted in int64, where the reference counts in int32 and would wrap
    past 2^31 - 1 products; the values agree wherever the reference's fit.
    """
    rows = csr_row_ids(a.indptr, a.nnz_cap)
    valid = a.valid_mask()
    n = b_row_nnz.shape[0]
    contrib = torch.where(valid, b_row_nnz[a.indices.clamp(0, n - 1).long()], 0)
    row_flops = torch.zeros(a.m, dtype=torch.int64, device=a.device)
    row_flops.index_add_(0, rows, contrib.long())
    maxrf = row_flops.max() if a.m > 0 else row_flops.sum()
    return row_flops.sum(), row_flops, maxrf


def compression_decision(a: CSR, b: CSR, bc: CompressedMatrix):
    """Host-facing: (CF, CMRF, use_compression). Mirrors the 15% rule."""
    fm, _, maxrf = flops_stats(a, b.row_nnz())
    fm_c, _, maxrf_c = flops_stats(a, bc.row_nnz())
    with span("host.read", site="compression_decision.fm"):
        fm = max(int(fm), 1)
    with span("host.read", site="compression_decision.maxrf"):
        maxrf = max(int(maxrf), 1)
    with span("host.read", site="compression_decision.fm_c"):
        cf = float(int(fm_c)) / fm
    with span("host.read", site="compression_decision.maxrf_c"):
        cmrf = float(int(maxrf_c)) / maxrf
    return cf, cmrf, cf <= COMPRESSION_CF_CUTOFF


def bitmask_rows(b: CSR) -> torch.Tensor:
    """(m, ceil(k/32)) int32 dense bitmask of B's structure (the symbolic
    kernel's feed). A row's column bits are distinct, so adding them is
    OR-ing them, and two's-complement adds keep bit 31 right."""
    k32 = -(-b.k // BITS)
    rows = csr_row_ids(b.indptr, b.nnz_cap)
    valid = b.valid_mask()
    csi = torch.where(valid, b.indices >> 5, 0)
    cs = torch.where(valid, bit_of(b.indices), 0)
    rows = torch.where(valid, rows, 0)
    out = torch.zeros(b.m * k32, dtype=torch.int32, device=b.device)
    out.index_add_(0, rows.long() * k32 + csi.long(), cs)
    return out.view(b.m, k32)


def row_popcounts(words: torch.Tensor) -> torch.Tensor:
    """(rows,) int32: the set bits of each row of an (rows, k32) bitmask."""
    return popcount(words).sum(-1, dtype=torch.int32)
