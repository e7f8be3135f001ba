"""The port's batched solver against the JAX package, and its own
bitwise invariants.

Against JAX the oracle is the reference's ``engine="phases"`` at
tolerance: the same statuses, iterations within ±1 and ``x`` within
``rtol=1e-4, atol=1e-6`` (the solve hold of ``tests/test_backend_diff``).
It is never bitwise: the row dots reduce in another order, and on this
JAX the reference's own VM and phases engines can differ by an iteration.

Inside the port the contract is bitwise: VM ≡ phases, row-ELL ≡ SELL,
``steps_per_sync`` 1 ≡ 8, and detection on ≡ off for healthy lanes.
"""
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

import repro.sparse as ref_sparse
from repro.core.batch import jpcg_solve_batched as ref_solve

import repro_torch.sparse as port_sparse
from repro_torch.core.batch import jpcg_solve_batched
from repro_torch.core.metrics import reset_solver_metrics, solver_metrics

SCHEMES = ["fp64", "mixed_v1", "mixed_v2", "mixed_v3"]
LAYOUTS = [("xla", "rowell"), ("xla", "sell"), ("pallas", "ellpack")]
BK = dict(block_rows=128, col_tile=128)
TOL, MAXITER = 1e-12, 500


def _bag(mod):
    return [mod.poisson_2d(10),
            mod.diag_dominant_spd(120, nnz_per_row=6, dominance=1.3, seed=5),
            mod.powerlaw_spd(200, alpha=2.1, seed=5)]


def _x(r):
    return np.asarray(r.x)


def _assert_close_to_reference(got, ref):
    """Same status, iterations ±1, x at the solve tolerance."""
    for g, (a, b) in enumerate(zip(got, ref)):
        assert a.status == b.status, f"lane {g}: {a.status} != {b.status}"
        assert abs(a.iterations - b.iterations) <= 1, f"lane {g}"
        np.testing.assert_allclose(_x(a), _x(b), rtol=1e-4, atol=1e-6)


def _assert_bitwise(got, ref):
    for g, (a, b) in enumerate(zip(got, ref)):
        assert a.iterations == b.iterations, f"lane {g}"
        assert a.status == b.status, f"lane {g}"
        assert torch.equal(a.x, b.x), f"lane {g}: x differs"


def _solve(engine="vm", **kw):
    kw = {**dict(tol=TOL, maxiter=MAXITER, **BK), **kw}
    return jpcg_solve_batched(_bag(port_sparse), device="cpu",
                              engine=engine, **kw)


@pytest.mark.parametrize("backend,layout", LAYOUTS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_solve_matches_jax_phases(scheme, backend, layout):
    kw = dict(tol=TOL, maxiter=MAXITER, scheme=scheme, backend=backend,
              layout=layout, **BK)
    ref_kw = dict(kw, interpret=True) if backend == "pallas" else kw
    ref = ref_solve(_bag(ref_sparse), engine="phases", **ref_kw)
    got = _solve(**kw)
    assert all(r.status == "CONVERGED" for r in got)
    _assert_close_to_reference(got, ref)


@pytest.mark.parametrize("backend,layout", LAYOUTS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_vm_bitwise_equals_phases(scheme, backend, layout):
    kw = dict(scheme=scheme, backend=backend, layout=layout)
    _assert_bitwise(_solve("vm", **kw), _solve("phases", **kw))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_rowell_bitwise_equals_sell(scheme):
    _assert_bitwise(_solve(scheme=scheme, layout="rowell"),
                    _solve(scheme=scheme, layout="sell"))


@pytest.mark.parametrize("engine", ["vm", "phases"])
def test_steps_per_sync_is_bitwise_neutral(engine):
    one = _solve(engine, steps_per_sync=1, with_trace=True)
    eight = _solve(engine, steps_per_sync=8, with_trace=True)
    _assert_bitwise(one, eight)
    for a, b in zip(one, eight):
        assert np.array_equal(a.residual_trace, b.residual_trace)
        assert len(a.residual_trace) == a.iterations


def _singular_j(n):
    i = np.repeat(np.arange(n), n)
    j = np.tile(np.arange(n), n)
    b = np.zeros(n)
    b[0], b[1] = 1.0, -1.0
    return (i, j, np.ones(n * n), (n, n)), b


def _indefinite_block(n):
    i = np.concatenate([np.arange(n - 2), [n - 2, n - 2, n - 1, n - 1]])
    j = np.concatenate([np.arange(n - 2), [n - 2, n - 1, n - 2, n - 1]])
    v = np.concatenate([np.ones(n - 2), [1.0, 2.0, 2.0, 1.0]])
    b = np.zeros(n)
    b[n - 2] = 1.0
    return (i, j, v, (n, n)), b


def _poison_bag(mod, n=24):
    """2 healthy lanes + singular + mid-run indefinite + NaN rhs (the
    constructions of tests/test_health.py)."""
    probs = [mod.tridiagonal_spd(n), mod.poisson_2d(5)]
    bs = [np.ones(n), np.ones(25)]
    for coo, b in (_singular_j(n), _indefinite_block(n)):
        probs.append(mod.csr_from_coo(*coo))
        bs.append(b)
    nan_b = np.ones(n)
    nan_b[3] = np.nan
    probs.append(mod.tridiagonal_spd(n))
    bs.append(nan_b)
    return probs, bs


@pytest.mark.parametrize("backend,layout", LAYOUTS)
@pytest.mark.parametrize("scheme", ["fp64", "mixed_v3"])
def test_poisoned_bag_statuses_match_jax(scheme, backend, layout):
    kw = dict(tol=1e-10, maxiter=200, scheme=scheme, backend=backend,
              layout=layout, **BK)
    ref_kw = dict(kw, interpret=True) if backend == "pallas" else kw
    probs, bs = _poison_bag(ref_sparse)
    ref = ref_solve(probs, bs, engine="phases", **ref_kw)
    probs, bs = _poison_bag(port_sparse)
    on = jpcg_solve_batched(probs, bs, device="cpu", **kw)
    assert [r.status for r in on] == [r.status for r in ref] == [
        "CONVERGED", "CONVERGED", "BREAKDOWN_INDEFINITE",
        "BREAKDOWN_INDEFINITE", "BREAKDOWN_NONFINITE"]
    _assert_close_to_reference(on[:2], ref[:2])
    assert [r.iterations for r in on[2:]] == [r.iterations for r in ref[2:]]
    # detection is bit-invisible to healthy lanes, and the phases engine
    # freezes every lane at the same state as the VM
    off = jpcg_solve_batched(probs, bs, device="cpu", detect=False, **kw)
    _assert_bitwise(on[:2], off[:2])
    _assert_bitwise(on, jpcg_solve_batched(probs, bs, device="cpu",
                                           engine="phases", **kw))


def test_solver_metrics_account_exactly():
    reset_solver_metrics()
    res = _solve()
    m = solver_metrics()
    its = sum(r.iterations for r in res)
    assert m.get("iterations") == its
    assert m.get("spmv_calls") == its + len(res)
    assert m.exit_histogram == {"CONVERGED": len(res)}


def test_unported_options_raise():
    """``interpret=`` has no counterpart in the port; ``mesh=`` is ported
    (tests/test_torch_shard.py) and names the devices in place of
    ``device=``."""
    bag = _bag(port_sparse)
    with pytest.raises(NotImplementedError, match="interpret"):
        jpcg_solve_batched(bag, device="cpu", interpret=True)
    with pytest.raises(ValueError, match="mesh"):
        jpcg_solve_batched(bag, device="cpu", mesh=("cpu",))
