"""The benchmark's own matrices: the CSR format, and the generators found
by name under ``bench/matrices/``, frozen copies of the port's.

``csr_from_coo`` is copied from ``src/repro_torch/sparse/csr.py`` (and
each generator from ``src/repro_torch/sparse/generators.py``) when the
benchmark was added, so that a change to the program cannot change the
inputs it is measured on.  Two steps are
spelled differently and give the same bits: the row-major sort is one
stable argsort of ``row * n + col`` in place of ``np.lexsort`` (the same
permutation, ties kept in input order, in less than half the time), and
duplicates are summed with ``np.bincount`` in place of ``np.add.at`` (the
same additions in the same order).  ``bench/tests/test_bench_inputs.py``
holds the generators to the port's, bit for bit.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List

import numpy as np

__all__ = ["Csr", "csr_from_coo", "make_matrices"]


@dataclasses.dataclass(frozen=True)
class Csr:
    """A square CSR matrix on the host: the benchmark's input format."""

    indptr: np.ndarray    # int64[n + 1]
    indices: np.ndarray   # int32[nnz], sorted within a row
    data: np.ndarray      # float64[nnz]
    n: int

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def row_ids(self) -> np.ndarray:
        return np.repeat(np.arange(self.n, dtype=np.int64),
                         np.diff(self.indptr))

    def diagonal(self) -> np.ndarray:
        rows = self.row_ids()
        on = self.indices == rows
        out = np.zeros(self.n, self.data.dtype)
        out[rows[on]] = self.data[on]
        return out


def csr_from_coo(rows, cols, vals, n: int) -> Csr:
    """CSR from COO triplets: rows sorted, columns sorted within a row,
    duplicates summed in input order."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    order = np.argsort(rows * n + cols, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size:
        key_change = np.empty(rows.shape[0], dtype=bool)
        key_change[0] = True
        key_change[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        group = np.cumsum(key_change) - 1
        vals = np.bincount(group, weights=vals,
                           minlength=int(group[-1]) + 1).astype(vals.dtype)
        rows = rows[key_change]
        cols = cols[key_change]
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return Csr(indptr=indptr, indices=cols.astype(np.int32), data=vals, n=n)


def make_matrices(config: dict, root) -> List[Csr]:
    """The matrices a configuration's ``matrices`` entries name, in order:
    each entry's ``generator`` is the module ``bench/matrices/<generator>.py``,
    whose ``generate`` takes the entry's other keys.  The same for every run,
    so that a seed changes the right-hand sides and not the work."""
    from harness.spec import load_module
    out = []
    for spec in config["matrices"]:
        gen = load_module(Path(root) / "bench" / "matrices"
                          / f"{spec['generator']}.py")
        out.append(gen.generate(**{k: v for k, v in spec.items()
                                   if k != "generator"}))
    return out
