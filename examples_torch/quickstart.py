"""Quickstart — solve a linear system with the PyTorch/CUDA port in 20
lines.

    PYTHONPATH=src python examples_torch/quickstart.py                # the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core.cg import jpcg_solve
from repro_torch.device import resolve_device
from repro_torch.sparse import csr_spmv, poisson_2d


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # A 2-D Poisson problem (ecology2-class structure, paper Table 3).
    A = poisson_2d(64)                 # 4096 × 4096, SPD
    print(f"matrix: n={A.shape[0]}, nnz={A.nnz}")

    # Paper protocol (§7.1): b = 1⃗, x0 = 0⃗, ‖r‖² < 1e-12, 20k-iteration cap.
    res = jpcg_solve(A, scheme="mixed_v3", tol=1e-12, maxiter=20_000,
                     device=dev)
    print(res)

    b = np.ones(A.shape[0])
    true_resid = np.linalg.norm(csr_spmv(A, res.x.cpu().numpy()) - b)
    print(f"‖A·x − b‖ = {true_resid:.3e}")

    # The same solve under the paper's other precision schemes:
    out = {"mixed_v3": res, "true_resid": float(true_resid)}
    for scheme in ("fp64", "mixed_v1"):
        r = jpcg_solve(A, scheme=scheme, tol=1e-12, maxiter=20_000,
                       device=dev)
        print(f"{scheme:9s}: {r.iterations} iterations, "
              f"converged={r.converged}")
        out[scheme] = r
    return out


if __name__ == "__main__":
    main()
