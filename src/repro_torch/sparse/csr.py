"""Host-side CSR container and reference operations (a copy of
:mod:`repro.sparse.csr`).

CSR is the interchange format: generators produce CSR, and the packed
batched layouts (:mod:`repro_torch.sparse.stacking`) are derived from
it.  Arrays are kept as numpy on the host; device placement happens when
a solver or kernel consumes them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["CSRMatrix", "csr_from_coo", "csr_to_dense", "csr_spmv"]


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Compressed-sparse-row matrix (host-side, numpy arrays)."""

    indptr: np.ndarray   # int64[n_rows + 1]
    indices: np.ndarray  # int32[nnz] column indices, sorted within a row
    data: np.ndarray     # value dtype [nnz]
    shape: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "CSRMatrix":
        return CSRMatrix(self.indptr, self.indices, self.data.astype(dtype),
                         self.shape)

    def diagonal(self) -> np.ndarray:
        """Extract the main diagonal (the Jacobi preconditioner source)."""
        n = min(self.shape)
        diag = np.zeros(n, dtype=self.data.dtype)
        row_ids = np.repeat(np.arange(self.n_rows, dtype=np.int64), self.row_nnz())
        mask = (self.indices == row_ids) & (row_ids < n)
        diag[row_ids[mask]] = self.data[mask]
        return diag

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def is_symmetric(self, tol: float = 0.0) -> bool:
        """Structural + value symmetry check (dense fallback for small n)."""
        if self.n_rows != self.n_cols:
            return False
        if self.n_rows <= 4096:
            d = csr_to_dense(self)
            return bool(np.allclose(d, d.T, atol=tol, rtol=0.0))
        # sampled check for large matrices
        rng = np.random.default_rng(0)
        rows = rng.integers(0, self.n_rows, size=512)
        for i in rows:
            for k in range(self.indptr[i], self.indptr[i + 1]):
                j = self.indices[k]
                v = self.data[k]
                row_j = slice(self.indptr[j], self.indptr[j + 1])
                hit = np.searchsorted(self.indices[row_j], i)
                base = self.indptr[j] + hit
                if hit >= self.indptr[j + 1] - self.indptr[j] or self.indices[base] != i:
                    return False
                if abs(self.data[base] - v) > tol:
                    return False
        return True


def csr_from_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 shape: Tuple[int, int], sum_duplicates: bool = True) -> CSRMatrix:
    """Build CSR from COO triplets (duplicates summed, rows sorted)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_duplicates and rows.size:
        key_change = np.empty(rows.shape[0], dtype=bool)
        key_change[0] = True
        key_change[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        group = np.cumsum(key_change) - 1
        uniq = int(group[-1]) + 1
        new_vals = np.zeros(uniq, dtype=vals.dtype)
        np.add.at(new_vals, group, vals)
        rows = rows[key_change]
        cols = cols[key_change]
        vals = new_vals
    indptr = np.zeros(shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRMatrix(indptr=indptr, indices=cols.astype(np.int32), data=vals, shape=shape)


def csr_to_dense(a: CSRMatrix) -> np.ndarray:
    out = np.zeros(a.shape, dtype=a.data.dtype)
    row_ids = np.repeat(np.arange(a.n_rows, dtype=np.int64), a.row_nnz())
    out[row_ids, a.indices] = a.data
    return out


def csr_spmv(a: CSRMatrix, x: np.ndarray) -> np.ndarray:
    """Reference SpMV (numpy; fp64 accumulation via bincount)."""
    acc_dtype = np.result_type(a.data.dtype, x.dtype)
    row_ids = np.repeat(np.arange(a.n_rows, dtype=np.int64), a.row_nnz())
    prod = a.data.astype(np.float64) * x[a.indices].astype(np.float64)
    out = np.bincount(row_ids, weights=prod, minlength=a.n_rows)
    return out.astype(acc_dtype)
