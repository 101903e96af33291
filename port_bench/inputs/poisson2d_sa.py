"""Inputs of a smoothed-aggregation multigrid level on the 2-D Poisson problem,
made on the device in a few large torch calls.

A is the 5-point operator (Galeri's ``Laplace2D``: 4 on the diagonal, -1 to
each grid neighbour) on an nx x ny grid, numbered row-major; it is the same
matrix as ``repro_torch.sparse.generators.stencil2d_csr`` builds (a frozen,
vectorised copy: each row's entries come out in column order, so no sort is
needed). The prolongator is MueLu's default, smoothed aggregation:

* aggregates of ``aggregate`` = (ax, ay) grid points, placed geometrically
  (the last ones along an axis are narrower where the grid does not divide);
* the tentative prolongator P_tent from the QR of the constant null space on
  each aggregate: the point's entry is 1/sqrt(aggregate size);
* P = (I - omega/lambda D^-1 A) P_tent, with omega = ``damping`` (MueLu's
  ``sa: damping factor``) and lambda = ``lambda_max``, the bound of D^-1 A
  taken in place of MueLu's eigenvalue estimate;
* R = P^T (MueLu's default restriction for symmetric problems).

Every sum is taken in a fixed order (no atomics), so a structure and its
values are the same on every run. The structure depends on the
configuration alone; ``value_sets`` draws the values of A for each step from
the seed: the 5-point values times a variable diffusion coefficient,
0.5 (kappa_i + kappa_j) for the entry (i, j), with kappa uniform in
[0.5, 1.5) at each grid point.

torch only; nothing of the program under test.
"""
from __future__ import annotations

import torch


def stencil(nx: int, ny: int, device):
    """The 5-point operator as (indptr, indices, values) in CSR, row-major."""
    n = nx * ny
    idx = torch.arange(n, device=device)
    ii, jj = idx // ny, idx % ny
    offsets = torch.tensor([-ny, -1, 0, 1, ny], device=device)  # in column order
    ok = torch.stack([ii > 0, jj > 0, torch.ones_like(ii, dtype=torch.bool),
                      jj < ny - 1, ii < nx - 1], dim=1)
    cols = idx[:, None] + offsets[None, :]
    vals = torch.where(offsets == 0, 4.0, -1.0).double().expand(n, 5)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(ok.sum(dim=1), 0)
    return indptr, cols[ok], vals[ok]


def smoothed_prolongator(nx: int, ny: int, agg: tuple, damping: float,
                         lambda_max: float, a_indptr, a_indices, a_values):
    """P = (I - damping/lambda_max D^-1 A) P_tent in CSR (column-sorted rows),
    and the number of aggregates."""
    dev = a_indices.device
    n = nx * ny
    ax, ay = agg
    cx, cy = -(-nx // ax), -(-ny // ay)
    idx = torch.arange(n, device=dev)
    agg_of = (idx // ny // ax) * cy + (idx % ny) // ay
    size = torch.bincount(agg_of, minlength=cx * cy)
    p_tent = size[agg_of].double().rsqrt()
    # row r of A·P_tent sums a_rc p_tent[c] into column agg_of[c]; every row
    # of A has at most w entries, so merge within rows on an (n, w) grid
    row_nnz = a_indptr.diff()
    w = int(row_nnz.max())
    rows = torch.repeat_interleave(idx, row_nnz)
    slot = torch.arange(a_indices.shape[0], device=dev) - a_indptr[:-1][rows]
    big = torch.iinfo(torch.int64).max
    cols = torch.full((n, w), big, dtype=torch.int64, device=dev)
    vals = torch.zeros((n, w), dtype=torch.float64, device=dev)
    cols[rows, slot] = agg_of[a_indices]
    vals[rows, slot] = a_values * p_tent[a_indices]
    cols, order = torch.sort(cols, dim=1, stable=True)
    vals = torch.gather(vals, 1, order)
    live = cols != big
    head = torch.ones_like(live)
    head[:, 1:] = cols[:, 1:] != cols[:, :-1]
    head &= live
    last = live.clone()
    last[:, :-1] &= head[:, 1:] | ~live[:, 1:]
    run = torch.zeros_like(vals)  # running sum within each column group, in order
    cur = torch.zeros(n, dtype=torch.float64, device=dev)
    for k in range(w):
        cur = torch.where(head[:, k], vals[:, k], cur + vals[:, k])
        run[:, k] = cur
    ap, p_cols = run[last], cols[last]
    p_rows = torch.repeat_interleave(idx, last.sum(dim=1))
    d = torch.zeros(n, dtype=torch.float64, device=dev)
    is_diag = a_indices == rows
    d[rows[is_diag]] = a_values[is_diag]
    p_vals = -(damping / lambda_max) * ap / d[p_rows]
    own = p_cols == agg_of[p_rows]
    p_vals[own] += p_tent[p_rows[own]]
    p_indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    p_indptr[1:] = torch.cumsum(last.sum(dim=1), 0)
    return (p_indptr, p_cols, p_vals), cx * cy


def transpose(indptr, indices, values, shape):
    """The CSR of the transpose, columns sorted within each row."""
    m, k = shape
    rows = torch.repeat_interleave(torch.arange(m, device=indices.device), indptr.diff())
    cols, order = torch.sort(indices, stable=True)
    t_indptr = torch.zeros(k + 1, dtype=torch.int64, device=indices.device)
    t_indptr[1:] = torch.cumsum(torch.bincount(cols, minlength=k), 0)
    return t_indptr, rows[order], values[order]


def operands(cfg: dict, seed: int, structure: int, device) -> dict:
    """The multigrid level's operands on ``device``, name -> (indptr, indices,
    values, shape): int32 indices, float32 values. One structure; the seed
    only draws values (``value_sets``)."""
    if structure != 0:
        raise ValueError("the multigrid level has one structure")
    nx, ny = cfg["grid"]
    n = nx * ny
    a = stencil(nx, ny, device)
    p, nc = smoothed_prolongator(nx, ny, tuple(cfg["aggregate"]), cfg["damping"],
                                 cfg["lambda_max"], *a)
    r = transpose(*p, (n, nc))

    def pack(x, shape):
        ip, idx, val = x
        return ip.int(), idx.int(), val.float(), shape

    return {"A": pack(a, (n, n)), "P": pack(p, (n, nc)), "R": pack(r, (nc, n))}


def value_sets(cfg: dict, name: str, base, count: int, gen: torch.Generator) -> list:
    """``count`` value arrays of A on its device: the 5-point values times
    0.5 (kappa_i + kappa_j), kappa uniform in [0.5, 1.5) per grid point."""
    if name != "A":
        raise ValueError(f"only A's values vary in this configuration, not {name}")
    dev = base.values.device
    n = base.shape[0]
    nnz = base.nnz
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   (base.indptr[1:] - base.indptr[:-1]).long())
    cols = base.indices[:nnz].long()
    out = []
    for _ in range(count):
        kappa = torch.rand(n, generator=gen, device=dev) + 0.5
        out.append((base.values[:nnz] * 0.5 * (kappa[rows] + kappa[cols])).contiguous())
    return out
