"""CSR over torch tensors (port of ``repro/sparse/formats.py``).

A frozen dataclass in place of the reference's pytree. Like the reference it
carries a static capacity: ``indices``/``values`` hold ``nnz_cap >= nnz``
slots and validity comes from ``indptr``, never from sentinel values. Index
arrays are int32, so structure hashes and plan arrays match the reference
byte for byte. ``ELL`` (with ``csr_to_ell``/``ell_to_csr``) feeds the
numeric and symbolic kernels; BSR arrives with the kernel that reads it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix with static nnz capacity.

    indptr:  (m+1,) int32 — row pointers; indptr[m] == true nnz <= nnz_cap.
    indices: (nnz_cap,) int32 — column ids; slots >= indptr[m] are padding.
    values:  (nnz_cap,) any dtype.
    shape:   (m, k) python ints.
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    shape: tuple

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.shape[1]

    @property
    def nnz_cap(self) -> int:
        return self.indices.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def nnz(self) -> torch.Tensor:
        """True nnz, as a 0-d tensor on the matrix's device."""
        return self.indptr[-1]

    def row_nnz(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def valid_mask(self) -> torch.Tensor:
        """(nnz_cap,) bool — True for live entries."""
        return torch.arange(self.nnz_cap, dtype=torch.int32,
                            device=self.device) < self.indptr[-1]

    def to_dense(self) -> torch.Tensor:
        """Densify (for oracles and tests; O(m*k) memory)."""
        mask = self.valid_mask()
        rows = torch.where(mask, csr_row_ids(self.indptr, self.nnz_cap), 0)
        cols = torch.where(mask, self.indices, 0)
        vals = torch.where(mask, self.values, 0)
        out = torch.zeros(self.shape, dtype=self.values.dtype, device=self.device)
        return out.index_put_((rows.long(), cols.long()), vals, accumulate=True)

    @staticmethod
    def from_dense(x, nnz_cap: int | None = None, device="cuda") -> "CSR":
        """Host-side construction from a dense array or tensor (test helper)."""
        x = (x.detach().cpu() if isinstance(x, torch.Tensor)
             else torch.as_tensor(np.asarray(x)))
        m, k = x.shape
        rows, cols = torch.nonzero(x, as_tuple=True)  # row-major, as np.nonzero
        nnz = rows.shape[0]
        cap = nnz_cap if nnz_cap is not None else max(nnz, 1)
        if cap < nnz:
            from repro_torch.runtime.validate import CapacityOverflowError
            raise CapacityOverflowError(
                f"nnz_cap={cap} < nnz={nnz}: the requested capacity cannot "
                f"hold the dense input's live entries")
        indptr = torch.zeros(m + 1, dtype=torch.int32)
        indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m), 0)
        indices = torch.zeros(cap, dtype=torch.int32)
        indices[:nnz] = cols
        values = torch.zeros(cap, dtype=x.dtype)
        values[:nnz] = x[rows, cols]
        return CSR(indptr=indptr.to(device), indices=indices.to(device),
                   values=values.to(device), shape=(int(m), int(k)))

    @staticmethod
    def from_arrays(indptr, indices, values, shape, validate: bool = True,
                    device=None) -> "CSR":
        """Wrap pre-built arrays (tensors or numpy) as a CSR.

        ``device=None`` keeps tensors where they are and puts numpy arrays
        on the card. ``validate=True`` runs the reference's cheap shape
        checks (array-length agreement and shape sanity, never an O(nnz)
        content scan), raising ``SpgemmInputError``.
        """
        def _to(x, dtype=None):
            if device is None and not isinstance(x, torch.Tensor):
                return torch.as_tensor(x, dtype=dtype, device="cuda")
            return torch.as_tensor(x, dtype=dtype, device=device)

        mat = CSR(indptr=_to(indptr, torch.int32),
                  indices=_to(indices, torch.int32),
                  values=_to(values), shape=tuple(int(s) for s in shape))
        if validate:
            from repro_torch.runtime.validate import SpgemmInputError

            shape = mat.shape
            if len(shape) != 2 or any(s < 0 for s in shape):
                raise SpgemmInputError(
                    f"shape must be a non-negative (m, k) pair, got {shape}")
            if mat.indptr.shape[0] != shape[0] + 1:
                raise SpgemmInputError(
                    f"len(indptr) == {mat.indptr.shape[0]} but shape[0]+1 "
                    f"== {shape[0] + 1}")
            if mat.indices.shape[0] != mat.values.shape[0]:
                raise SpgemmInputError(
                    f"len(indices) == {mat.indices.shape[0]} != "
                    f"len(values) == {mat.values.shape[0]}")
        return mat


def csr_row_ids(indptr: torch.Tensor, nnz_cap: int) -> torch.Tensor:
    """(nnz_cap,) int32 row id per CSR slot; padded slots clamp to m-1.

    Scatter 1 at each row start, cumsum. The reference's scatter drops the
    index ``nnz_cap`` (``mode="drop"``), which ``index_add_`` would reject:
    the marks get one extra slot that is sliced off.
    """
    m = indptr.shape[0] - 1
    marks = torch.zeros(nnz_cap + 1, dtype=torch.int32, device=indptr.device)
    marks.index_add_(0, indptr[1:].clamp(0, nnz_cap),
                     torch.ones(m, dtype=torch.int32, device=indptr.device))
    row = torch.cumsum(marks[:nnz_cap], 0, dtype=torch.int32)
    return torch.clamp(row, max=m - 1)


@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK: every row padded to a fixed width r_pad.

    indices: (m, r_pad) int32 — padded slots hold 0.
    values:  (m, r_pad) dtype — padded slots hold 0 (so numerics ignore them).
    row_nnz: (m,) int32 — live width per row.
    shape:   (m, k).
    """

    indices: torch.Tensor
    values: torch.Tensor
    row_nnz: torch.Tensor
    shape: tuple

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.shape[1]

    @property
    def r_pad(self) -> int:
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def valid_mask(self) -> torch.Tensor:
        return (torch.arange(self.r_pad, dtype=torch.int32, device=self.device)[None, :]
                < self.row_nnz[:, None])

    def to_dense(self) -> torch.Tensor:
        """Densify (for oracles and tests; O(m*k) memory)."""
        mask = self.valid_mask()
        rows = torch.arange(self.m, device=self.device)[:, None].expand(self.indices.shape)
        out = torch.zeros(self.shape, dtype=self.values.dtype, device=self.device)
        return out.index_put_((rows[mask], self.indices[mask].long()),
                              self.values[mask], accumulate=True)


def csr_to_ell(a: CSR, r_pad: int | None = None) -> ELL:
    """CSR -> ELL; the host decides ``r_pad`` (the widest row) when it is not
    given. Rows wider than ``r_pad`` keep their first ``r_pad`` entries and
    ``row_nnz`` still says their full width, as in the reference.

    Where the reference gathers through three (m, r_pad) index arrays, the
    port scatters each live CSR slot to its ELL position, so the transients
    are O(nnz) and only the two outputs are (m, r_pad).
    """
    row_nnz = a.row_nnz()
    if r_pad is None:
        r_pad = max(int(row_nnz.max()) if a.m else 0, 1)
    dev = a.device
    idx = torch.zeros(a.m, r_pad, dtype=torch.int32, device=dev)
    val = torch.zeros(a.m, r_pad, dtype=a.values.dtype, device=dev)
    nnz = int(a.indptr[-1]) if a.m else 0
    if nnz:
        rows = csr_row_ids(a.indptr, nnz).long()
        pos = torch.arange(nnz, dtype=torch.int64, device=dev) - a.indptr[rows].long()
        keep = pos < r_pad
        flat = (rows * r_pad + pos)[keep]
        idx.view(-1)[flat] = a.indices[:nnz][keep]
        val.view(-1)[flat] = a.values[:nnz][keep]
    return ELL(indices=idx, values=val, row_nnz=row_nnz.to(torch.int32), shape=a.shape)


def ell_to_csr(e: ELL, nnz_cap: int | None = None) -> CSR:
    """ELL -> CSR (test helper): the live slots of each row, in order."""
    rn = e.row_nnz.long()
    indptr = torch.zeros(e.m + 1, dtype=torch.int32, device=e.device)
    indptr[1:] = torch.cumsum(rn, 0)
    nnz = int(indptr[-1])
    cap = int(nnz_cap if nnz_cap is not None else max(nnz, 1))
    mask = e.valid_mask()
    indices = torch.zeros(cap, dtype=torch.int32, device=e.device)
    values = torch.zeros(cap, dtype=e.values.dtype, device=e.device)
    indices[:nnz] = e.indices[mask]
    values[:nnz] = e.values[mask]
    return CSR(indptr=indptr, indices=indices, values=values, shape=e.shape)
