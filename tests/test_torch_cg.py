"""The port's single-system ``jpcg_solve`` against the JAX package's.

Both solvers start from the same operator arrays: the JAX operator is
built once and carried into the port with :mod:`repro_torch.convert`.
For ``vsr`` × {``xla``, ``pallas``} and ``pipelined`` × ``xla`` over a
stencil, a dense-backed random SPD and a skewed matrix the port must end
where JAX ends: both converged, iterations within ±1, and ``x`` within
``rtol=1e-4, atol=1e-6`` (the reference's own ``test_backend_diff``
hold).  The port sums in another order than XLA and the Pallas kernels,
so it is held to that tolerance, never bitwise.  ``pipelined`` runs at
fp64 and mixed_v3 only: under mixed_v1 the reference's own pipelined
solve does not converge on these matrices within 20,000 iterations.  Its
iterations are held within ±2, not ±1: on random_spd(64) at mixed_v3 its
recurrence ‖r‖² oscillates around 1e-12 for the last five iterations, and
the reference's own two backends stop 2 iterations apart there (xla 57,
pallas 55).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

import repro.sparse as ref_sparse
from repro.core import phases as ref_phases
from repro.core.cg import jpcg_solve as ref_jpcg_solve
from repro.core.operators import as_operator as ref_as_operator
from repro.core.precision import get_scheme as ref_get_scheme
from repro.kernels.ops import ell_operator_pallas as ref_ell_operator

import repro_torch
import repro_torch.sparse as port_sparse
from repro_torch import convert
from repro_torch.core import phases
from repro_torch.core.cg import jpcg_solve
from repro_torch.core.operators import (CallableOperator, DenseOperator,
                                        as_operator)
from repro_torch.core.precision import get_scheme
from repro_torch.kernels import ops

TOL = 1e-12
MATRICES = {
    "poisson_2d(12)": lambda m: m.poisson_2d(12),
    "random_spd(64)": lambda m: m.random_spd(64, cond=100.0, seed=3),
    "diag_dominant_spd(150)": lambda m: m.diag_dominant_spd(
        150, nnz_per_row=8, dominance=1.2, seed=7),
}
CASES = ([("vsr", "xla", s) for s in ("fp64", "mixed_v1", "mixed_v3")]
         + [("vsr", "pallas", s) for s in ("fp64", "mixed_v1", "mixed_v3")]
         + [("pipelined", "xla", s) for s in ("fp64", "mixed_v3")])


def _ref_operator(a, scheme, backend):
    if backend == "pallas":
        return ref_ell_operator(a, scheme, block_rows=128, col_tile=128,
                                interpret=True)
    return ref_as_operator(a, scheme, block_rows=8, col_tile=128)


def _assert_same_solve(got, want, *, iters=1):
    assert got.converged and want.converged
    assert abs(got.iterations - want.iterations) <= iters, (
        got.iterations, want.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("method,backend,scheme", CASES)
@pytest.mark.parametrize("name", list(MATRICES))
def test_solve_matches_reference(name, method, backend, scheme):
    ref_op = _ref_operator(MATRICES[name](ref_sparse), scheme, backend)
    op = convert.operator_to_torch(ref_op, device="cpu")
    ops.reset_launches()
    got = jpcg_solve(op, method=method, backend=backend, scheme=scheme,
                     tol=TOL, device="cpu", with_trace=True)
    want = ref_jpcg_solve(ref_op, method=method, backend=backend,
                          scheme=scheme, tol=TOL, with_trace=True)
    _assert_same_solve(got, want, iters=2 if method == "pipelined" else 1)
    assert got.x.device.type == "cpu" and got.x.dtype == torch.float64
    assert got.status is None and (got.scheme, got.method) == (scheme,
                                                                method)
    assert got.residual_trace.shape == (got.iterations,)
    assert got.residual_trace[-1] == got.rr <= TOL
    # CPU tensors take the plain versions: no kernel launched
    assert set(ops.launches().values()) == {0}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_from_csr_matches_reference(backend):
    """The port packs the CSR itself (``csr_to_bell`` / ``csr_to_ellpack``
    copies) to the same operator the reference builds."""
    kw = (dict(block_rows=128, col_tile=128) if backend == "pallas"
          else dict(block_rows=8, col_tile=128))
    a = MATRICES["diag_dominant_spd(150)"]
    got = jpcg_solve(a(port_sparse), backend=backend, tol=TOL,
                     device="cpu", **kw)
    want = ref_jpcg_solve(a(ref_sparse), backend=backend, tol=TOL, **kw)
    _assert_same_solve(got, want)
    ref_op = _ref_operator(a(ref_sparse), "mixed_v3", backend)
    op = (ops.ell_operator_pallas if backend == "pallas" else as_operator)(
        a(port_sparse), "mixed_v3", device="cpu", **kw)
    op_c = convert.operator_to_torch(ref_op, device="cpu")
    for f in ("tile_cols", "vals", "local_cols", "diag"):
        assert torch.equal(getattr(op, f), getattr(op_c, f)), f


def test_maxiter_trace_and_x0():
    a = MATRICES["diag_dominant_spd(150)"]
    ref_op = _ref_operator(a(ref_sparse), "fp64", "pallas")
    op = convert.operator_to_torch(ref_op, device="cpu")
    got = jpcg_solve(op, backend="pallas", scheme="fp64", tol=1e-30,
                     maxiter=7, with_trace=True, device="cpu")
    want = ref_jpcg_solve(ref_op, backend="pallas", scheme="fp64",
                          tol=1e-30, maxiter=7, with_trace=True)
    assert got.iterations == want.iterations == 7 and not got.converged
    np.testing.assert_allclose(got.residual_trace, want.residual_trace,
                               rtol=1e-10)
    x0 = np.random.default_rng(1).standard_normal(op.n)
    same = jpcg_solve(op, x0=x0, maxiter=0, device="cpu", backend="pallas")
    assert same.iterations == 0 and np.array_equal(same.x.numpy(), x0)
    got = jpcg_solve(op, x0=x0, b=2.0 * np.ones(op.n), scheme="fp64",
                     backend="pallas", tol=TOL, device="cpu")
    want = ref_jpcg_solve(ref_op, jnp.asarray(2.0 * np.ones(op.n)),
                          jnp.asarray(x0), scheme="fp64", backend="pallas",
                          tol=TOL)
    _assert_same_solve(got, want)


def test_state_carried_across():
    """A JAX ``CGState`` stepped 5 iterations, converted and continued in
    the port, ends where the JAX loop ends."""
    sch, rsch = get_scheme("fp64"), ref_get_scheme("fp64")
    ref_op = _ref_operator(MATRICES["poisson_2d(12)"](ref_sparse), "fp64",
                           "xla")
    d = ref_op.diag
    b = jnp.ones(ref_op.n)
    st0 = ref_phases.init_state(ref_op.matvec, d, b, jnp.zeros(ref_op.n),
                                maxiter=200, scheme=rsch, with_trace=True)
    st5 = ref_phases.jpcg_loop(ref_op.matvec, d, st0, tol=TOL, maxiter=5,
                               scheme=rsch)
    want = jax.jit(lambda s: ref_phases.jpcg_loop(
        ref_op.matvec, d, s, tol=TOL, maxiter=200, scheme=rsch))(st5)
    op = convert.operator_to_torch(ref_op, device="cpu")
    st = convert.cg_state_to_torch(st5, device="cpu")
    assert int(st.i) == 5 and st.trace.shape == (200,)
    got = phases.jpcg_loop(op.matvec, op.diag, st, tol=TOL, maxiter=200,
                           scheme=sch)
    assert abs(int(got.i) - int(want.i)) <= 1 and float(got.rr) <= TOL
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-4,
                               atol=1e-6)
    assert np.array_equal(got.trace[:5].numpy(), np.asarray(st5.trace[:5]))
    assert int(st.i) == 5          # the input state is left as it was


def test_dense_and_callable_operators():
    a = MATRICES["random_spd(64)"](port_sparse)
    dense = np.zeros(a.shape)
    for i in range(a.shape[0]):
        lo, hi = a.indptr[i], a.indptr[i + 1]
        dense[i, a.indices[lo:hi]] = a.data[lo:hi]
    want = ref_jpcg_solve(dense, scheme="fp64", tol=TOL)
    got = jpcg_solve(dense, scheme="fp64", tol=TOL, device="cpu")
    assert isinstance(as_operator(dense, "fp64", device="cpu"),
                      DenseOperator)
    _assert_same_solve(got, want)
    got_k = jpcg_solve(dense, scheme="fp64", tol=TOL, device="cpu",
                       backend="pallas", block_rows=32, col_tile=32)
    _assert_same_solve(got_k, want)

    dj = jnp.asarray(dense)
    dt = torch.from_numpy(dense)
    diag = np.diag(dense)
    want_c = ref_jpcg_solve(lambda x: dj @ x, scheme="fp64", tol=TOL,
                            diag=diag, n=64)
    got_c = jpcg_solve(lambda x: dt @ x, scheme="fp64", tol=TOL, diag=diag,
                       n=64, device="cpu")
    assert isinstance(as_operator(lambda x: x, "fp64", diag=diag, n=64,
                                  device="cpu"), CallableOperator)
    _assert_same_solve(got_c, want_c)


def test_entry_point_exports_and_errors():
    assert repro_torch.jpcg_solve is jpcg_solve
    assert repro_torch.core.jpcg_solve is jpcg_solve
    a = port_sparse.poisson_2d(4)
    with pytest.raises(ValueError, match="backend"):
        jpcg_solve(a, backend="tpu", device="cpu")
    with pytest.raises(ValueError, match="method"):
        jpcg_solve(a, method="cgs", device="cpu")


def test_default_device_refuses_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = port_sparse.poisson_2d(4)
    for backend in ("xla", "pallas"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            jpcg_solve(a, backend=backend)
