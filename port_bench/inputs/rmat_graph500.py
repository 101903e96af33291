"""Graph500 RMAT graphs as CSR adjacency matrices, for A·A.

The edge list is the Graph500 Kronecker generator's: ``edge_factor * 2^scale``
edges, each placed bit by bit into one of four quadrants with probabilities
a, b, c and 1 - a - b - c (a frozen copy of
``repro_torch.sparse.generators.rmat_csr``'s loop), then the vertex labels are
randomly permuted, as Graph500 does. Edges stay directed; duplicates are
merged, their values summed.

Every seed gets the same set of structures: the edges of structure s are
drawn from ``structure_seeds[s]`` of the configuration, so the sizes (nnz,
products, nnz of the result) are the same for every seed. The seed draws the
vertex permutation and the values (standard normal, float32), so each run's
inputs differ and a relabelling cannot be remembered between runs.

NumPy and torch only; nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch


def kronecker_edges(scale: int, edge_factor: int, a: float, b: float, c: float,
                    rng: np.random.Generator):
    """(rows, cols) of the Kronecker generator's edges, int64."""
    nnz = (1 << scale) * edge_factor
    rows = np.zeros(nnz, np.int64)
    cols = np.zeros(nnz, np.int64)
    for bit in range(scale):
        r = rng.random(nnz)
        row_bit = (r >= a + b).astype(np.int64)
        col_bit = ((r >= a) & (r < a + b) | (r >= a + b + c)).astype(np.int64)
        rows |= row_bit << bit
        cols |= col_bit << bit
    return rows, cols


def to_csr(rows, cols, vals, n: int):
    """CSR with duplicates summed and columns sorted within each row."""
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    head = np.ones(key.shape[0], bool)
    head[1:] = key[1:] != key[:-1]
    out = np.zeros(int(head.sum()), vals.dtype)
    np.add.at(out, np.cumsum(head) - 1, vals)
    key = key[head]
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(key // n, minlength=n))
    return indptr, key % n, out


def operands(cfg: dict, seed: int, structure: int, device) -> dict:
    """{"A": (indptr, indices, values, shape)} on ``device`` (int32 indices,
    float32 values) for structure ``structure``, labels and values drawn
    from ``seed``."""
    scale = cfg["scale"]
    n = 1 << scale
    a, b, c = cfg["initiator"]
    rows, cols = kronecker_edges(scale, cfg["edge_factor"], a, b, c,
                                 np.random.default_rng(cfg["structure_seeds"][structure]))
    rng = np.random.default_rng([seed % (1 << 64), structure])
    perm = rng.permutation(n)
    vals = rng.standard_normal(rows.shape[0])
    indptr, indices, values = to_csr(perm[rows], perm[cols], vals, n)
    def move(x, dtype):
        return torch.from_numpy(x.astype(dtype)).to(device)

    return {"A": (move(indptr, np.int32), move(indices, np.int32),
                  move(values, np.float32), (n, n))}


def value_sets(cfg: dict, name: str, base, count: int, gen: torch.Generator) -> list:
    """``count`` new edge weights of ``name`` on its device: standard normal."""
    dev = base.values.device
    return [torch.randn(base.nnz, generator=gen, device=dev) for _ in range(count)]
