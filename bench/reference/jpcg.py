"""Plain Jacobi-preconditioned CG in PyTorch: the reference that decides
``correct``, and, one precision down, the control that must fail it.

It imports nothing of the program.  It follows Callipepla's Algorithm 1
as the configuration states it: the matrix's values rounded to the
scheme's matrix dtype, every vector and every sum at the vector dtype,
the Jacobi diagonal taken from the matrix as generated, x0 = 0, and the
loop run while ``i < maxiter`` and ``r·r > tol`` (``tol`` rounded to the
vector dtype), checked before each iteration.  The SpMV is PyTorch's CSR
matrix-vector product.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

__all__ = ["RefMatrix", "Result", "jpcg", "residual_rr"]

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclasses.dataclass
class Result:
    """What a solve says: its x, iterations and exit status."""

    x: torch.Tensor
    iterations: int
    status: str


class RefMatrix:
    """The CSR matrix on ``device``: values rounded to ``matrix_dtype`` and
    held at ``vector_dtype``, and the Jacobi diagonal at ``vector_dtype``.
    """

    def __init__(self, indptr, indices, data, diag, *, matrix_dtype: str,
                 vector_dtype: str, device):
        vd = _DTYPES[vector_dtype]
        vals = np.asarray(data).astype(matrix_dtype).astype(vector_dtype)
        n = len(indptr) - 1
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # CSR support is "beta"
            self.a = torch.sparse_csr_tensor(
                torch.as_tensor(np.asarray(indptr, np.int64)),
                torch.as_tensor(np.asarray(indices, np.int64)),
                torch.as_tensor(vals), size=(n, n),
                check_invariants=False).to(device)
        self.diag = torch.as_tensor(np.asarray(diag)).to(device, vd)
        self.n, self.dtype, self.device = n, vd, torch.device(device)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return torch.mv(self.a, x)


def jpcg(m: RefMatrix, b: torch.Tensor, *, tol: float,
         maxiter: int) -> Result:
    """Solve ``A x = b`` from x0 = 0."""
    vd = m.dtype
    tol_v = float(torch.tensor(tol, dtype=vd))
    b = b.to(m.device, vd)
    x = torch.zeros_like(b)
    r = b - m.matvec(x)
    z = r / m.diag
    p = z
    rz, rr = torch.dot(r, z), torch.dot(r, r)
    i, status = 0, "MAXITER"
    while i < maxiter:
        rr_h = float(rr)
        if not np.isfinite(rr_h):
            status = "BREAKDOWN_NONFINITE"
            break
        if rr_h <= tol_v:
            status = "CONVERGED"
            break
        ap = m.matvec(p)
        pap = torch.dot(p, ap)
        if float(pap) <= 0:
            status = "BREAKDOWN_INDEFINITE"
            break
        alpha = rz / pap
        r = r - alpha * ap
        rr = torch.dot(r, r)
        z = r / m.diag
        rz_new = torch.dot(r, z)
        beta = rz_new / rz
        p, x = z + beta * p, x + alpha * p
        rz = rz_new
        i += 1
    else:
        if float(rr) <= tol_v:
            status = "CONVERGED"
    return Result(x=x, iterations=i, status=status)


def residual_rr(m: RefMatrix, x: torch.Tensor, b: torch.Tensor) -> float:
    """``‖b − A x‖²`` at the reference's precision: how far an answer is
    from solving its system, whoever computed it."""
    r = b.to(m.device, m.dtype) - m.matvec(x.to(m.device, m.dtype))
    return float(torch.dot(r, r))
