"""The port's SolverEngine against the JAX engine, and its own invariants.

Against JAX: the same statuses, iterations within ±1 and ``x`` within
``rtol=1e-4, atol=1e-6``.  The port's warm-up dot is the batch runner's
row dot where the reference spells it ``jnp.dot`` — another reduction
order, so the engines agree to the solve tolerance, not bitwise.

Inside the port: compaction and donation are bitwise neutral, and
``bytes_streamed_est`` equals the packed-array accounting exactly.
"""
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

import repro.sparse as ref_sparse
from repro.serve.solver_engine import (SolverEngine as RefEngine,
                                       SolverEngineConfig as RefConfig)

import repro_torch.sparse as port_sparse
from repro_torch.core.batch import jpcg_solve_batched
from repro_torch.kernels.spmv import sell_table
from repro_torch.serve import SolverEngine, SolverEngineConfig
from repro_torch.sparse.stacking import stack_sell

CASES = [("xla", "auto"), ("xla", "sell"), ("pallas", "auto")]
BK = dict(block_rows=128, col_tile=128)


def _singular_j(mod, n):
    i = np.repeat(np.arange(n), n)
    j = np.tile(np.arange(n), n)
    b = np.zeros(n)
    b[0], b[1] = 1.0, -1.0
    return mod.csr_from_coo(i, j, np.ones(n * n), (n, n)), b


def _requests(mod):
    """(matrix, rhs) in submission order; the last one is larger than
    the rest, so admitting it mid-run grows the pool's bucket."""
    return [(mod.poisson_2d(9), None),
            (mod.diag_dominant_spd(100, nnz_per_row=6, dominance=1.3,
                                   seed=2), None),
            _singular_j(mod, 12),
            (mod.powerlaw_spd(150, alpha=2.1, seed=3), None),
            (mod.diag_dominant_spd(300, nnz_per_row=8, dominance=1.2,
                                   seed=7), None)]


def _run(engine_cls, mod, cfg, *, grow_mid_run=True):
    """Results in submission order.  Without a mid-run growth the largest
    request goes first, so the pool's row bucket is sized once (the
    reference engine compiles once per bucket shape)."""
    eng = engine_cls(cfg)
    reqs = _requests(mod)
    head = reqs[:-1] if grow_mid_run else reqs[::-1]
    rids = [eng.submit(a, b) for a, b in head]
    out = {}
    if grow_mid_run:
        out.update(eng.step())
        rids.append(eng.submit(*reqs[-1]))
    out.update(eng.run_to_completion())
    return eng, [out[r] for r in rids]


@pytest.mark.parametrize("scheme,backend,layout,grow", [
    ("fp64", "xla", "auto", False), ("mixed_v1", "xla", "sell", True),
    ("mixed_v3", "pallas", "auto", False)])
def test_engine_matches_jax(scheme, backend, layout, grow):
    """Row-ELL, SELL (with a bucket growth mid-run) and ELLPACK pools."""
    kw = dict(batch_slots=8, chunk_iters=8, scheme=scheme, backend=backend,
              layout=layout, **BK)
    _, ref = _run(RefEngine, ref_sparse, RefConfig(**kw), grow_mid_run=grow)
    eng, got = _run(SolverEngine, port_sparse,
                    SolverEngineConfig(device="cpu", **kw),
                    grow_mid_run=grow)
    for g, (a, b) in enumerate(zip(got, ref)):
        assert a.status == b.status, f"request {g}"
        assert abs(a.iterations - b.iterations) <= 1, f"request {g}"
        np.testing.assert_allclose(np.asarray(a.x), np.asarray(b.x),
                                   rtol=1e-4, atol=1e-6)
    assert got[2].status == "BREAKDOWN_INDEFINITE"
    assert got[2].iterations == 0
    m = eng.metrics()
    assert m["admits"] == 5 and m["harvests"] == 5
    assert m["growths"] >= (2 if grow else 1)
    assert sum(m["exit_status"].values()) == 5


@pytest.mark.parametrize("backend,layout", CASES)
def test_compaction_is_bitwise_neutral(backend, layout):
    kw = dict(batch_slots=8, chunk_iters=4, backend=backend, layout=layout,
              device="cpu", **BK)
    eng_c, packed = _run(SolverEngine, port_sparse,
                         SolverEngineConfig(compact_fraction=0.5, **kw))
    eng_n, plain = _run(SolverEngine, port_sparse,
                        SolverEngineConfig(compact_fraction=0.0, **kw))
    assert eng_c.metrics()["compactions"] >= 1
    assert "compactions" not in eng_n.metrics()
    for a, b in zip(packed, plain):
        assert (a.iterations, a.status) == (b.iterations, b.status)
        assert torch.equal(a.x, b.x)


@pytest.mark.parametrize("donate", [True, False])
def test_donation_is_bitwise_neutral(donate):
    kw = dict(batch_slots=8, chunk_iters=4, device="cpu", **BK)
    _, got = _run(SolverEngine, port_sparse,
                  SolverEngineConfig(donate=donate, **kw))
    _, ref = _run(SolverEngine, port_sparse,
                  SolverEngineConfig(donate=True, steps_per_sync=1, **kw))
    for a, b in zip(got, ref):
        assert (a.iterations, a.status) == (b.iterations, b.status)
        assert torch.equal(a.x, b.x)


@pytest.mark.parametrize("backend,layout", CASES)
def test_bytes_streamed_est_is_exact(backend, layout):
    """SpMV events (one warm-up per admit, one per committed iteration,
    one discarded tick per in-loop breakdown) × the per-lane packed
    stream read off the pool's tensors at each event."""
    eng = SolverEngine(SolverEngineConfig(
        batch_slots=8, chunk_iters=8, backend=backend, layout=layout,
        device="cpu", **BK))

    def lane_bytes(pool):
        stream = (pool.mat[1:3] if backend == "pallas"
                  and pool.layout != "sell" else pool.mat[:2])
        return sum(t.numel() * t.element_size() for t in stream) \
            // pool.slots

    expected, rids = 0, []
    for a, b in _requests(port_sparse):
        rids.append(eng.submit(a, b))
        expected += lane_bytes(eng._pool(None, None))
    done = eng.run_to_completion()
    pool = eng._pool(None, None)
    for rid in rids:
        r = done[rid]
        broke = r.status.startswith("BREAKDOWN") and np.isfinite(r.rr)
        expected += (r.iterations + int(broke)) * lane_bytes(pool)
    assert eng.metrics()["bytes_streamed_est"] == expected


def test_escalation_retries_breakdown_at_fp64():
    """A matrix whose fp32 packing rounds singular breaks down in the
    mixed pool; the engine retries it once at fp64 under the same id."""
    eps = 1e-9           # 1 - eps rounds to 1.0 in float32
    a = np.array([[1.0, 1.0 - eps], [1.0 - eps, 1.0]])
    eng = SolverEngine(SolverEngineConfig(
        scheme="mixed_v3", batch_slots=4, chunk_iters=8,
        escalate_fp64=True, device="cpu"))
    rid = eng.submit(a, np.array([1.0, 0.0]), tol=1e-8, maxiter=50)
    res = eng.run_to_completion()[rid]
    assert res.retried and res.converged
    assert res.scheme == "fp64" and res.status == "CONVERGED"
    m = eng.metrics()
    assert m["escalations"] == 1
    assert m["exit_status"] == {"CONVERGED": 1}


def test_escalation_is_single_shot():
    a, b = _singular_j(port_sparse, 8)
    eng = SolverEngine(SolverEngineConfig(
        scheme="mixed_v3", batch_slots=4, chunk_iters=8,
        escalate_fp64=True, device="cpu"))
    rid = eng.submit(a, b, tol=1e-10, maxiter=50)
    res = eng.run_to_completion()[rid]
    assert res.retried and not res.converged
    assert res.scheme == "fp64" and res.status == "BREAKDOWN_INDEFINITE"
    assert eng.metrics()["escalations"] == 1


def test_free_slots_and_pool_routing():
    eng = SolverEngine(SolverEngineConfig(batch_slots=4, device="cpu"))
    assert eng.free_slots() == 4
    eng.submit(port_sparse.poisson_2d(5))
    eng.submit(port_sparse.poisson_2d(5), scheme="fp64")
    assert eng.free_slots() == 6
    assert eng.free_slots(pool=("fp64", None)) == 3
    assert eng.free_slots(pool=("mixed_v1", None)) == 4
    done = eng.run_to_completion()
    assert {r.scheme for r in done.values()} == {"mixed_v3", "fp64"}
    assert eng.free_slots() == 8


def _check_sell_table(pool):
    """The pool's table is the one rebuilt from the slots' CSRs: the
    occupied lanes' widths as ``stack_sell`` packs them in the pool's
    geometry, and the host's grid (the most blocks a lane needs) read off
    the table it launches."""
    occupied = [s for s, r in enumerate(pool.req_of_slot) if r is not None]
    lw = pool.lane_widths
    assert lw.shape[0] == pool.slots
    if occupied:
        st = stack_sell([pool.csr_of_slot[s] for s in occupied],
                        n_pad=pool.bucket[0], widths=pool.sell_widths,
                        scheme=pool.scheme)
        assert st.groups == pool.groups
        assert np.array_equal(lw[occupied], st.lane_widths)
    table = pool.mat[3]
    want = sell_table(pool.groups, device="cpu", lane_widths=lw,
                      slice_rows=table.slice_rows)
    assert torch.equal(table.entries, want.entries)
    assert torch.equal(table.block_map, want.block_map)
    assert torch.equal(table.lane_widths, want.lane_widths)
    bmap = table.block_map.numpy()
    assert table.block_map.shape[0] == pool.slots
    assert table.grid_x == want.grid_x == (bmap >= 0).sum(axis=1).max()


def test_sell_pool_lane_table_through_admit_compact_readmit():
    """Lanes of very different widths admitted into one SELL pool, the
    pool compacted, lanes admitted again: after every step the kernel's
    table matches the lanes, and the solves match the batched solver."""
    mats = [port_sparse.tridiagonal_spd(60),
            port_sparse.diag_dominant_spd(200, nnz_per_row=80,
                                          dominance=1.2, seed=8),
            port_sparse.powerlaw_spd(150, alpha=2.1, seed=3),
            port_sparse.poisson_2d(9),
            port_sparse.tridiagonal_spd(90)]
    eng = SolverEngine(SolverEngineConfig(
        batch_slots=8, chunk_iters=8, layout="sell", compact_fraction=0.5,
        device="cpu", **BK))
    rids = {}
    for a in mats[:4]:
        rids[eng.submit(a)] = a
        _check_sell_table(eng._pool(None, None))
    pool = eng._pool(None, None)
    assert pool.layout == "sell"
    m = eng.metrics()            # the first admit allocates; the rest grow
    assert m["admits"] - 1 - m.get("growths", 0) >= 1, "none packed in place"
    out = {}
    while len(out) < 3:                 # the stencils finish first
        out.update(eng.step())
        _check_sell_table(pool)
    assert eng.metrics()["compactions"] >= 1 and pool.slots < 8
    for a in (mats[4], mats[0]):        # re-admission after compaction
        rids[eng.submit(a)] = a
        _check_sell_table(pool)
    out.update(eng.run_to_completion())
    _check_sell_table(pool)
    assert set(out) == set(rids)
    want = jpcg_solve_batched(list(rids.values()), layout="sell",
                              device="cpu")
    for (rid, a), w in zip(rids.items(), want):
        got = out[rid]
        assert got.status == w.status == "CONVERGED"
        assert abs(got.iterations - w.iterations) <= 1
        np.testing.assert_allclose(np.asarray(got.x), np.asarray(w.x),
                                   rtol=1e-4, atol=1e-6)
