"""Multiplication counts (port of ``flops_stats`` in ``repro/core/compression.py``).

The bitmask compression of the symbolic phase (``compress_matrix``,
``bitmask_rows``, ``compression_decision``) arrives with the dense method
and its symbolic kernel.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.formats import CSR, csr_row_ids


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
