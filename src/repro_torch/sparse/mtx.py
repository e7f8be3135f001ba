"""MatrixMarket (.mtx) I/O — SuiteSparse-compatible coordinate format (a
copy of :mod:`repro.sparse.mtx` on the port's CSR).

Implemented natively (no scipy dependency in the data path) so the solver
stack is self-contained; handles ``real``/``integer`` + ``general``/
``symmetric`` coordinate headers, which covers the paper's whole Table 3.
"""
from __future__ import annotations

import gzip
import io
from pathlib import Path

import numpy as np

from repro_torch.sparse.csr import CSRMatrix, csr_from_coo

__all__ = ["read_mtx", "write_mtx"]


def _open(path: str | Path):
    path = Path(path)
    if path.suffix == ".gz":
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def read_mtx(path: str | Path, dtype=np.float64) -> CSRMatrix:
    with _open(path) as f:
        header = f.readline().strip().lower().split()
        if len(header) < 5 or header[0] != "%%matrixmarket" or header[1] != "matrix":
            raise ValueError(f"not a MatrixMarket matrix file: {path}")
        fmt, field, symmetry = header[2], header[3], header[4]
        if fmt != "coordinate":
            raise ValueError(f"only coordinate format supported, got {fmt}")
        if field not in ("real", "integer", "pattern"):
            raise ValueError(f"unsupported field {field}")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        n_rows, n_cols, nnz = (int(t) for t in line.split())
        body = np.loadtxt(f, dtype=np.float64, ndmin=2, max_rows=nnz)
    if body.size == 0:
        body = np.zeros((0, 3))
    rows = body[:, 0].astype(np.int64) - 1
    cols = body[:, 1].astype(np.int64) - 1
    vals = body[:, 2].astype(dtype) if body.shape[1] > 2 else np.ones(rows.shape[0], dtype)
    if symmetry == "symmetric":
        off = rows != cols
        rows = np.concatenate([rows, cols[off]])
        cols = np.concatenate([cols, body[off, 0].astype(np.int64) - 1])
        vals = np.concatenate([vals, vals[off]])
    elif symmetry != "general":
        raise ValueError(f"unsupported symmetry {symmetry}")
    return csr_from_coo(rows, cols, vals, (n_rows, n_cols))


def write_mtx(path: str | Path, a: CSRMatrix, symmetric: bool = False) -> None:
    sym = "symmetric" if symmetric else "general"
    row_ids = np.repeat(np.arange(a.n_rows, dtype=np.int64), a.row_nnz())
    cols = a.indices.astype(np.int64)
    vals = a.data
    if symmetric:
        keep = row_ids >= cols  # store lower triangle
        row_ids, cols, vals = row_ids[keep], cols[keep], vals[keep]
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate real {sym}\n")
        f.write(f"{a.n_rows} {a.n_cols} {row_ids.shape[0]}\n")
        for r, c, v in zip(row_ids, cols, vals):
            f.write(f"{r + 1} {c + 1} {v:.17g}\n")
