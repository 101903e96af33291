"""Sparse matrix generators (port of ``repro/sparse/generators.py``).

The structure and values are made in numpy with
``numpy.random.default_rng(seed)`` exactly as in the reference, so both
packages build byte-identical operands from the same arguments; only the
final arrays move to ``device``. ``dtype`` is a numpy or torch float dtype
that numpy can represent (float16/32/64); duplicate COO entries are summed in
that dtype, as the reference does. The reference stores f64 as f32 (JAX runs
with x64 off); the port keeps f64.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.formats import CSR

_NUMPY_DTYPES = {torch.float16: np.float16, torch.float32: np.float32,
                 torch.float64: np.float64}


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        if dtype not in _NUMPY_DTYPES:
            from repro_torch.runtime.validate import SpgemmConfigError
            raise SpgemmConfigError(
                f"generators make values in numpy, which has no {dtype}; "
                f"generate float32 and cast the values")
        return np.dtype(_NUMPY_DTYPES[dtype])
    return np.dtype(dtype)


def _dedupe_coo(rows, cols, vals, m, k):
    key = rows.astype(np.int64) * k + cols.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    keep = np.ones(len(key), bool)
    keep[1:] = key[1:] != key[:-1]
    # accumulate duplicate values into the kept slot
    seg = np.cumsum(keep) - 1
    out_vals = np.zeros(int(keep.sum()), vals.dtype)
    np.add.at(out_vals, seg, vals)
    return rows[keep], cols[keep], out_vals


def _csr_from_numpy(indptr, indices, values, shape, device) -> CSR:
    return CSR(indptr=torch.from_numpy(np.ascontiguousarray(indptr, np.int32)).to(device),
               indices=torch.from_numpy(np.ascontiguousarray(indices, np.int32)).to(device),
               values=torch.from_numpy(np.ascontiguousarray(values)).to(device),
               shape=(int(shape[0]), int(shape[1])))


def _coo_to_csr(rows, cols, vals, m, k, dtype, device) -> CSR:
    rows, cols, vals = _dedupe_coo(rows, cols, vals.astype(_np_dtype(dtype)), m, k)
    indptr = np.zeros(m + 1, np.int32)
    np.add.at(indptr[1:], rows, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return _csr_from_numpy(indptr, cols, vals, (m, k), device)


def random_csr(m: int, k: int, avg_nnz_per_row: float, seed: int = 0,
               dtype=np.float32, device="cuda") -> CSR:
    """Uniform random sparsity (Erdos-Renyi-like rows)."""
    rng = np.random.default_rng(seed)
    nnz = max(int(m * avg_nnz_per_row), 1)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, k, nnz)
    vals = rng.standard_normal(nnz)
    return _coo_to_csr(rows, cols, vals, m, k, dtype, device)


def rmat_csr(scale: int, edge_factor: int = 8, seed: int = 0,
             a: float = 0.57, b: float = 0.19, c: float = 0.19,
             dtype=np.float32, device="cuda") -> CSR:
    """RMAT power-law graph (the paper squares RMAT matrices)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    nnz = n * edge_factor
    rows = np.zeros(nnz, np.int64)
    cols = np.zeros(nnz, np.int64)
    for bit in range(scale):
        r = rng.random(nnz)
        # quadrant probabilities a, b, c, d
        row_bit = (r >= a + b).astype(np.int64)
        col_bit = ((r >= a) & (r < a + b) | (r >= a + b + c)).astype(np.int64)
        rows |= row_bit << bit
        cols |= col_bit << bit
    vals = rng.standard_normal(nnz)
    return _coo_to_csr(rows, cols, vals, n, n, dtype, device)


def banded_csr(m: int, bandwidth: int, seed: int = 0, dtype=np.float32,
               device="cuda") -> CSR:
    """Banded matrix (FEM-like bounded row degree)."""
    rng = np.random.default_rng(seed)
    offsets = np.arange(-bandwidth, bandwidth + 1)
    rows = np.repeat(np.arange(m), len(offsets))
    cols = rows + np.tile(offsets, m)
    ok = (cols >= 0) & (cols < m)
    rows, cols = rows[ok], cols[ok]
    vals = rng.standard_normal(len(rows))
    return _coo_to_csr(rows, cols, vals, m, m, dtype, device)


def stencil2d_csr(nx: int, ny: int, dtype=np.float32, device="cuda") -> CSR:
    """5-point Poisson stencil on an nx*ny grid — the A_fine of multigrid."""
    n = nx * ny
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    idx = (ii * ny + jj).ravel()
    rows, cols, vals = [idx], [idx], [np.full(n, 4.0)]
    for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ni, nj = ii + di, jj + dj
        ok = ((ni >= 0) & (ni < nx) & (nj >= 0) & (nj < ny)).ravel()
        rows.append(idx[ok])
        cols.append((ni * ny + nj).ravel()[ok])
        vals.append(np.full(int(ok.sum()), -1.0))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    return _coo_to_csr(rows, cols, vals, n, n, dtype, device)


def aggregation_prolongator(n_fine: int, agg_size: int = 4, seed: int = 0,
                            dtype=np.float32, device="cuda") -> CSR:
    """Piecewise-constant aggregation prolongator P (n_fine x n_coarse):
    every ``agg_size`` consecutive fine points map to one coarse aggregate."""
    n_coarse = (n_fine + agg_size - 1) // agg_size
    rows = np.arange(n_fine)
    cols = rows // agg_size
    vals = np.ones(n_fine)
    return _coo_to_csr(rows, cols, vals, n_fine, n_coarse, dtype, device)


def _transpose_numpy(indptr, indices, values, shape):
    """Sparse transpose of a CSR held in numpy: a stable argsort on the
    column ids keeps the row order within every output row. Explicit zeros
    are dropped, which makes the result equal to the reference's
    ``CSR.from_dense(dense.T)`` (``np.nonzero``, row-major)."""
    m, k = shape
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    cols, vals = indices[:nnz], values[:nnz]
    live = vals != 0
    rows, cols, vals = rows[live], cols[live], vals[live]
    order = np.argsort(cols, kind="stable")
    t_indptr = np.zeros(k + 1, np.int32)
    np.add.at(t_indptr[1:], cols, 1)
    t_indptr = np.cumsum(t_indptr).astype(np.int32)
    t_indices = rows[order].astype(np.int32)
    t_values = vals[order]
    if len(t_values) == 0:  # from_dense keeps one padding slot
        t_indices = np.zeros(1, np.int32)
        t_values = np.zeros(1, values.dtype)
    return t_indptr, t_indices, t_values, (k, m)


def galerkin_triple(nx: int = 32, ny: int = 32, agg_size: int = 4,
                    seed: int = 0, device="cuda"):
    """Return (R, A, P) with R = P^T for a Galerkin coarse-grid product R*A*P.

    The reference builds R through a dense P; the port transposes sparsely
    (``_transpose_numpy``), so full-size grids stay O(nnz)."""
    a = stencil2d_csr(nx, ny, device="cpu")
    p = aggregation_prolongator(nx * ny, agg_size, seed, device="cpu")
    r = _csr_from_numpy(*_transpose_numpy(p.indptr.numpy(), p.indices.numpy(),
                                          p.values.numpy(), p.shape), device)
    move = (lambda x: CSR(x.indptr.to(device), x.indices.to(device),
                          x.values.to(device), x.shape))
    return r, move(a), move(p)
