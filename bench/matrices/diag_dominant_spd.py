"""diag_dominant_spd: a random symmetric matrix, ``nnz_per_row / 2``
random columns a row and their transposes, with
``a_ii = dominance · Σ_j |a_ij|`` (the port's random-column lanes).

Copied from ``src/repro_torch/sparse/generators.py``'s
``diag_dominant_spd`` when the benchmark was added;
``bench/tests/test_bench_inputs.py`` holds it to the port's, bit for bit.
"""
import numpy as np

from harness.matrices import Csr, csr_from_coo


def generate(n: int, nnz_per_row: int, dominance: float, seed: int) -> Csr:
    rng = np.random.default_rng(seed)
    half = max(1, nnz_per_row // 2)
    rows = np.repeat(np.arange(n), half)
    cols = rng.integers(0, n, size=rows.shape[0])
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.shape[0])
    a = csr_from_coo(np.concatenate([rows, cols]),
                     np.concatenate([cols, rows]),
                     np.concatenate([vals, vals]), n)
    row_ids = a.row_ids()
    abssum = np.bincount(row_ids, weights=np.abs(a.data), minlength=n)
    diag_rows = np.arange(n)
    return csr_from_coo(
        np.concatenate([row_ids, diag_rows]),
        np.concatenate([a.indices.astype(np.int64), diag_rows]),
        np.concatenate([a.data, dominance * np.maximum(abssum, 1e-8)]), n)
