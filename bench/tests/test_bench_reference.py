"""The plain reference against a dense solve, and the roofline's counts."""
import numpy as np
import pytest
import torch

from harness.roofline import (HBM_BYTES_PER_S, bound_s, spmv_work,
                              vector_bytes)
from harness.spec import ROOT, load_module
from reference.jpcg import RefMatrix, jpcg, residual_rr

poisson_2d = load_module(ROOT / "bench" / "matrices"
                         / "poisson_2d.py").generate
diag_dominant_spd = load_module(ROOT / "bench" / "matrices"
                                / "diag_dominant_spd.py").generate


def _dense(a, dtype=np.float64):
    d = np.zeros((a.n, a.n))
    d[a.row_ids(), a.indices] = a.data.astype(dtype)
    return d


def _ref(a, mat="float64", vec="float64"):
    return RefMatrix(a.indptr, a.indices, a.data, a.diagonal(),
                     matrix_dtype=mat, vector_dtype=vec, device="cpu")


@pytest.mark.parametrize("a", [poisson_2d(9), diag_dominant_spd(
    200, 12, 1.1, 5), diag_dominant_spd(150, 30, 1.01, 6)],
    ids=["poisson", "dominant", "hard"])
def test_jpcg_against_a_dense_solve(a):
    b = torch.randn(a.n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    res = jpcg(_ref(a), b, tol=1e-20, maxiter=2000)
    want = np.linalg.solve(_dense(a), b.numpy())
    assert res.status == "CONVERGED" and 0 < res.iterations < 2000
    np.testing.assert_allclose(res.x.numpy(), want, rtol=1e-9, atol=1e-11)
    assert residual_rr(_ref(a), res.x, b) < 1e-18


def test_matrix_dtype_rounds_values_and_vectors_stay_wide():
    a = diag_dominant_spd(100, 10, 1.1, 3)
    m = _ref(a, mat="float32")
    assert m.a.dtype == torch.float64
    x = torch.randn(a.n, dtype=torch.float64)
    want = _dense(a, np.float32).astype(np.float64) @ x.numpy()
    np.testing.assert_allclose(m.matvec(x).numpy(), want, rtol=1e-13)
    assert _ref(a, mat="float32", vec="float32").matvec(
        x.float()).dtype == torch.float32


def test_maxiter_and_status():
    a = poisson_2d(20)
    b = torch.ones(a.n, dtype=torch.float64)
    res = jpcg(_ref(a), b, tol=1e-30, maxiter=5)
    assert (res.status, res.iterations) == ("MAXITER", 5)
    res = jpcg(_ref(a), torch.zeros(a.n, dtype=torch.float64), tol=0.0,
               maxiter=5)
    assert (res.status, res.iterations) == ("CONVERGED", 0)


def test_spmv_work_counts_nonzeros_not_slots():
    # mixed_v3: fp32 value + int32 index a nonzero, x read and y written
    # at fp64
    assert spmv_work(1000, 5000, "mixed_v3") == (5000 * 8 + 1000 * 16,
                                                 10000)
    assert spmv_work(10, 20, "fp64") == (20 * 12 + 10 * 16, 40)
    assert spmv_work(10, 20, "mixed_v1") == (20 * 8 + 10 * 8, 40)
    assert vector_bytes("dot", 10 ** 6, "mixed_v3") == 16 * 10 ** 6
    assert vector_bytes("phase2", 10 ** 6, "mixed_v3") == 32 * 10 ** 6
    assert vector_bytes("phase3", 10 ** 6, "mixed_v3") == 48 * 10 ** 6
    nbytes, flops = spmv_work(10 ** 6, 4_996_000, "mixed_v3")
    assert bound_s(nbytes, flops, "float64") == nbytes / HBM_BYTES_PER_S
    assert bound_s(0, 335 * 10 ** 9, "float64") == pytest.approx(0.01)
