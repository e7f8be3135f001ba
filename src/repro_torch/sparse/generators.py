"""Synthetic SPD problem generators (a copy of
:mod:`repro.sparse.generators`).

SuiteSparse is not reachable offline, so these generators reproduce the
*regimes* of the paper's Table 3 benchmark suite:

* ``poisson_2d`` / ``poisson_3d`` — discretized Laplacians: the
  `ecology2` / `tmt_sym` / `thermal` class (large N, ~5–7 nnz/row, κ ~ N).
* ``diag_dominant_spd`` — random structural-like matrices with tunable
  nnz/row and diagonal dominance: the `bcsstk` / `msc` / `raefsky` class
  (dominance → 1⁺ gives the slow-converging, 10k+-iteration problems that
  separate Mix-V1/V2 from Mix-V3 in the paper's Fig. 9).
* ``tridiagonal_spd`` — 1-D Poisson, exact spectrum known (κ controllable),
  used by property tests.
* ``benchmark_suite`` — the named problem set, small and large tiers
  mirroring Table 3's M1–M18 (3.9k–23k rows) and M19–M36 (123k–1.56M
  rows).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.sparse.csr import CSRMatrix, csr_from_coo

__all__ = [
    "poisson_2d", "poisson_3d", "tridiagonal_spd", "random_spd",
    "diag_dominant_spd", "powerlaw_spd", "benchmark_suite",
    "suite_metadata",
]


def poisson_2d(nx: int, ny: int | None = None, dtype=np.float64) -> CSRMatrix:
    """5-point Laplacian on an nx×ny grid (SPD, κ = O(n²))."""
    ny = ny or nx
    n = nx * ny
    idx = np.arange(n).reshape(nx, ny)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [np.full(n, 4.0)]
    for shift, axis in (((-1, 0), 0), ((1, 0), 0), ((0, -1), 1), ((0, 1), 1)):
        src = idx
        if axis == 0:
            dst = np.roll(idx, shift[0], axis=0)
            valid = np.ones_like(idx, dtype=bool)
            if shift[0] == -1:
                valid[-1, :] = False
            else:
                valid[0, :] = False
        else:
            dst = np.roll(idx, shift[1], axis=1)
            valid = np.ones_like(idx, dtype=bool)
            if shift[1] == -1:
                valid[:, -1] = False
            else:
                valid[:, 0] = False
        rows.append(src[valid].ravel())
        cols.append(dst[valid].ravel())
        vals.append(np.full(valid.sum(), -1.0))
    return csr_from_coo(np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals).astype(dtype), (n, n))


def poisson_3d(n_side: int, dtype=np.float64) -> CSRMatrix:
    """7-point Laplacian on an n³ grid."""
    n = n_side ** 3
    idx = np.arange(n).reshape(n_side, n_side, n_side)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [np.full(n, 6.0)]
    for axis in range(3):
        for d in (-1, 1):
            dst = np.roll(idx, d, axis=axis)
            valid = np.ones_like(idx, dtype=bool)
            sl = [slice(None)] * 3
            sl[axis] = -1 if d == -1 else 0
            valid[tuple(sl)] = False
            rows.append(idx[valid].ravel())
            cols.append(dst[valid].ravel())
            vals.append(np.full(valid.sum(), -1.0))
    return csr_from_coo(np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals).astype(dtype), (n, n))


def tridiagonal_spd(n: int, off: float = -1.0, diag: float = 2.0,
                    dtype=np.float64) -> CSRMatrix:
    """1-D Poisson [off, diag, off]; SPD iff diag > 2|off|·cos(π/(n+1))."""
    i = np.arange(n)
    rows = np.concatenate([i, i[:-1], i[1:]])
    cols = np.concatenate([i, i[1:], i[:-1]])
    vals = np.concatenate([np.full(n, diag), np.full(n - 1, off), np.full(n - 1, off)])
    return csr_from_coo(rows, cols, vals.astype(dtype), (n, n))


def diag_dominant_spd(n: int, nnz_per_row: int = 16, dominance: float = 1.05,
                      seed: int = 0, dtype=np.float64) -> CSRMatrix:
    """Random symmetric matrix with |a_ii| = dominance · Σ|a_ij|.

    ``dominance`` → 1⁺ yields ill-conditioned SPD systems (thousands of CG
    iterations, where mixed-precision schemes diverge in behavior);
    dominance ≫ 1 yields easy, well-conditioned systems.
    """
    rng = np.random.default_rng(seed)
    half = max(1, nnz_per_row // 2)
    rows = np.repeat(np.arange(n), half)
    cols = rng.integers(0, n, size=rows.shape[0])
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.shape[0])
    # Symmetrize: add the transpose triplets.
    rows_s = np.concatenate([rows, cols])
    cols_s = np.concatenate([cols, rows])
    vals_s = np.concatenate([vals, vals])
    a = csr_from_coo(rows_s, cols_s, vals_s.astype(dtype), (n, n))
    # Enforce diagonal dominance: diag = dominance * row abs-sum.
    row_ids = np.repeat(np.arange(n), a.row_nnz())
    abssum = np.bincount(row_ids, weights=np.abs(a.data), minlength=n)
    diag_rows = np.arange(n)
    diag_vals = dominance * np.maximum(abssum, 1e-8)
    all_rows = np.concatenate([row_ids, diag_rows])
    all_cols = np.concatenate([a.indices.astype(np.int64), diag_rows])
    all_vals = np.concatenate([a.data, diag_vals.astype(dtype)])
    return csr_from_coo(all_rows, all_cols, all_vals, (n, n))


def powerlaw_spd(n: int, alpha: float = 2.2, min_deg: int = 2,
                 max_deg: int | None = None, dominance: float = 1.2,
                 seed: int = 0, dtype=np.float64) -> CSRMatrix:
    """Power-law (skewed) degree SPD matrix — the sliced-ELL stress case.

    Off-diagonal degree of row i is drawn from a truncated Pareto
    (P(deg) ∝ deg^-alpha): most rows carry ``min_deg`` neighbors while a
    few hub rows carry up to ``max_deg``, so the global max row width W
    sits far above the mean and a global-W row-ELL layout pays padded
    work/bytes ∝ n·W ≫ nnz (the regime where SELL-C-σ slicing wins).
    Symmetrized and made diagonally dominant exactly like
    :func:`diag_dominant_spd`.
    """
    rng = np.random.default_rng(seed)
    max_deg = int(max_deg if max_deg is not None
                  else max(min_deg + 1, n // 4))
    u = rng.random(n)
    deg = np.floor(min_deg * u ** (-1.0 / (alpha - 1.0))).astype(np.int64)
    deg = np.clip(deg, min_deg, max_deg)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=rows.shape[0])
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.shape[0])
    # Symmetrize: add the transpose triplets.
    rows_s = np.concatenate([rows, cols])
    cols_s = np.concatenate([cols, rows])
    vals_s = np.concatenate([vals, vals])
    a = csr_from_coo(rows_s, cols_s, vals_s.astype(dtype), (n, n))
    # Enforce diagonal dominance: diag = dominance * row abs-sum.
    row_ids = np.repeat(np.arange(n), a.row_nnz())
    abssum = np.bincount(row_ids, weights=np.abs(a.data), minlength=n)
    diag_rows = np.arange(n)
    diag_vals = dominance * np.maximum(abssum, 1e-8)
    all_rows = np.concatenate([row_ids, diag_rows])
    all_cols = np.concatenate([a.indices.astype(np.int64), diag_rows])
    all_vals = np.concatenate([a.data, diag_vals.astype(dtype)])
    return csr_from_coo(all_rows, all_cols, all_vals, (n, n))


def random_spd(n: int, cond: float = 1e4, seed: int = 0,
               dtype=np.float64) -> CSRMatrix:
    """Dense-backed SPD with an exactly controlled condition number.

    Only for small n (tests): A = Q diag(λ) Qᵀ with log-spaced λ in
    [1/cond, 1]; returned as CSR of the dense array.
    """
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.logspace(-np.log10(cond), 0, n)
    a = (q * lam) @ q.T
    a = (a + a.T) / 2
    rows, cols = np.nonzero(np.ones_like(a, dtype=bool))
    return csr_from_coo(rows, cols, a[rows, cols].astype(dtype), (n, n))


# name -> (factory, kwargs, paper_analogue)
_SUITE: Dict[str, Tuple[Callable[..., CSRMatrix], dict, str]] = {
    # Table 3 M1–M18 class: medium rows, structural / ill-conditioned.
    "tri_small":      (tridiagonal_spd, dict(n=4096), "ted_B (10.6k, easy)"),
    "struct_easy":    (diag_dominant_spd, dict(n=5000, nnz_per_row=40, dominance=2.0, seed=1), "cbuckle class"),
    "struct_hard":    (diag_dominant_spd, dict(n=5357, nnz_per_row=38, dominance=1.01, seed=2), "s3rmt3m3 class (hard)"),
    "struct_med":     (diag_dominant_spd, dict(n=17361, nnz_per_row=58, dominance=1.08, seed=3), "gyro_k class"),
    "poisson2d_64":   (poisson_2d, dict(nx=64), "small thermal"),
    "poisson2d_132":  (poisson_2d, dict(nx=132), "bodyy4 class (17.5k)"),
    "powerlaw_skew":  (powerlaw_spd, dict(n=4096, alpha=2.1, seed=5), "HBM-skew class (power-law degree)"),
    # Table 3 M19–M36 class: large rows, 2D/3D problems.
    "poisson2d_500":  (poisson_2d, dict(nx=500), "thermal mid (250k)"),
    "poisson2d_1000": (poisson_2d, dict(nx=1000), "ecology2 class (1.0M rows)"),
    "poisson3d_50":   (poisson_3d, dict(n_side=50), "offshore class (125k)"),
    "poisson3d_100":  (poisson_3d, dict(n_side=100), "Serena class (1.0M, 3D)"),
    "struct_large":   (diag_dominant_spd, dict(n=148770, nnz_per_row=70, dominance=1.1, seed=4), "bmwcra_1 class"),
}


def benchmark_suite(tier: str = "all") -> Dict[str, CSRMatrix]:
    """Materialize the named suite. tier ∈ {small, large, all}."""
    small = ["tri_small", "struct_easy", "struct_hard", "struct_med",
             "poisson2d_64", "poisson2d_132", "powerlaw_skew"]
    large = ["poisson2d_500", "poisson2d_1000", "poisson3d_50",
             "poisson3d_100", "struct_large"]
    names = {"small": small, "large": large, "all": small + large}[tier]
    return {k: _SUITE[k][0](**_SUITE[k][1]) for k in names}


def suite_metadata() -> Dict[str, str]:
    return {k: v[2] for k, v in _SUITE.items()}
