"""poisson_2d: the 5-point Laplacian on an nx × nx grid (4 on the
diagonal, -1 to each neighbour), the ecology2 class.

Copied from ``src/repro_torch/sparse/generators.py``'s ``poisson_2d`` when
the benchmark was added; ``bench/tests/test_bench_inputs.py`` holds it to
the port's, bit for bit.
"""
import numpy as np

from harness.matrices import Csr, csr_from_coo


def generate(nx: int) -> Csr:
    n = nx * nx
    idx = np.arange(n).reshape(nx, nx)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [np.full(n, 4.0)]
    for shift, axis in (((-1, 0), 0), ((1, 0), 0), ((0, -1), 1), ((0, 1), 1)):
        valid = np.ones_like(idx, dtype=bool)
        if axis == 0:
            dst = np.roll(idx, shift[0], axis=0)
            valid[-1 if shift[0] == -1 else 0, :] = False
        else:
            dst = np.roll(idx, shift[1], axis=1)
            valid[:, -1 if shift[1] == -1 else 0] = False
        rows.append(idx[valid].ravel())
        cols.append(dst[valid].ravel())
        vals.append(np.full(valid.sum(), -1.0))
    return csr_from_coo(np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals), n)
