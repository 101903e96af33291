"""Pure-numpy SpGEMM oracles (port of ``repro/sparse/oracle.py``).

``gustavson_numpy`` is a literal transcription of the paper's Algorithm 1
(row-wise Gustavson with a dict accumulator) — the semantic ground truth.
``dense_spgemm_oracle`` is the O(m*n*k) densified check. Both take the
port's CSR (on any device: its arrays are copied to the host) and return
numpy arrays equal, bit for bit, to the reference's on the same operands.
Only the operands' fields are read (``indptr``, ``indices``, ``values``,
``m``, ``to_dense``), so any CSR whose arrays numpy can read will do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.formats import CSR


def _host(t) -> np.ndarray:
    """A tensor as numpy on the host (bfloat16 as float32, exactly); any
    other array-like through ``np.asarray``."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def dense_spgemm_oracle(a: CSR, b: CSR) -> np.ndarray:
    return _host(a.to_dense()) @ _host(b.to_dense())


def gustavson_numpy(a: CSR, b: CSR):
    """Algorithm 1 of the paper. Returns (indptr, indices, values) with
    per-row sorted column indices, plus per-row flops f_m (for MAXRF checks).
    """
    a_indptr = _host(a.indptr)
    a_indices = _host(a.indices)
    a_values = _host(a.values)
    b_indptr = _host(b.indptr)
    b_indices = _host(b.indices)
    b_values = _host(b.values)
    m = a.m

    indptr = np.zeros(m + 1, np.int32)
    all_cols, all_vals = [], []
    row_flops = np.zeros(m, np.int64)
    for i in range(m):
        acc: dict[int, float] = {}
        for e in range(a_indptr[i], a_indptr[i + 1]):
            j = int(a_indices[e])
            av = a_values[e]
            lo, hi = int(b_indptr[j]), int(b_indptr[j + 1])
            row_flops[i] += hi - lo
            for f in range(lo, hi):
                c = int(b_indices[f])
                acc[c] = acc.get(c, 0.0) + av * b_values[f]
        cols = np.array(sorted(acc.keys()), np.int32)
        all_cols.append(cols)
        all_vals.append(np.array([acc[int(c)] for c in cols], a_values.dtype))
        indptr[i + 1] = indptr[i] + len(cols)
    indices = np.concatenate(all_cols) if all_cols else np.zeros(0, np.int32)
    values = np.concatenate(all_vals) if all_vals else np.zeros(0, a_values.dtype)
    return indptr, indices, values, row_flops


def gustavson_ell_structure(a: CSR, b: CSR):
    """Symbolic structure of C = A*B in ELL layout, from the numpy oracle.

    Returns ``(c_idx, c_nnz)`` numpy arrays — ``c_idx`` (m, rC) per-row
    sorted columns (padded slots 0), ``c_nnz`` (m,) live widths — the
    numeric-phase kernels' structure inputs.
    """
    ip, ind, _, _ = gustavson_numpy(a, b)
    r_c = max(int(np.diff(ip).max()), 1)
    c_idx = np.zeros((a.m, r_c), np.int32)
    c_nnz = np.diff(ip).astype(np.int32)
    for i in range(a.m):
        c_idx[i, : c_nnz[i]] = ind[ip[i]: ip[i + 1]]
    return c_idx, c_nnz
