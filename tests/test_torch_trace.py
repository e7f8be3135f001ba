"""Spans and traced counters inside the port (``core/metrics``): off unless
a profiler session runs or ``enable_tracing(True)``; the solver loop's and
the engine's spans, their parents and root ids; the reads ``host_syncs``
counts; the record buffer's bound; the clock pair against the profiler's
clock."""
import time

import pytest
import torch
from _torch_pin import one_thread  # noqa: F401
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core import metrics
from repro_torch.core.cg import jpcg_solve
from repro_torch.core.metrics import (Metrics, enable_tracing,
                                      reset_solver_metrics, solver_metrics,
                                      traced_metrics, tracing)
from repro_torch.serve import SolverEngine, SolverEngineConfig
from repro_torch.sparse.generators import poisson_2d

BK = dict(block_rows=128, col_tile=128)
#: Counters that move only while tracing is on (besides each span's).
TRACED = {"host_syncs", "packed_nnz", "packed_bytes", "h2d_bytes",
          "d2h_bytes", "spans_dropped"}
SUBMIT_CHILDREN = {"submit.harvest", "admit.pack", "admit.grow",
                   "admit.copy", "admit.warmup"}
STEP_CHILDREN = {"step.account", "step.vm", "step.harvest", "step.compact"}


@pytest.fixture(autouse=True)
def untraced():
    """Every test starts and ends with tracing off and clean counters."""
    enable_tracing(False)
    reset_solver_metrics()
    yield
    enable_tracing(False)
    reset_solver_metrics()


def _solve(method="vsr"):
    return jpcg_solve(poisson_2d(10), backend="pallas", method=method,
                      device="cpu", **BK)


def _engine(layout="auto", backend="pallas"):
    """An engine that admitted three systems (one after a growth) and ran
    them out, then one more; returns it and the request ids."""
    eng = SolverEngine(SolverEngineConfig(
        batch_slots=4, chunk_iters=8, backend=backend, layout=layout,
        device="cpu", **BK))
    rids = [eng.submit(poisson_2d(n)) for n in (6, 9, 12)]
    eng.run_to_completion()
    rids.append(eng.submit(poisson_2d(7)))
    eng.run_to_completion()
    return eng, rids


def _traced_keys(snapshot: dict) -> set:
    return {k for k in snapshot
            if k.endswith((".ns", ".n")) or k in TRACED}


def test_off_by_default_records_and_counts_nothing():
    assert not tracing()
    _solve()
    eng, _ = _engine()
    assert solver_metrics().spans() == []
    assert _traced_keys(solver_metrics().snapshot()) == set()
    assert eng._metrics.spans() == []
    assert _traced_keys(eng.metrics()) == set()
    assert eng.metrics()["admits"] == 4          # the old counters count


@pytest.mark.parametrize("how", ["profiler", "enable_tracing"])
def test_on_while_switched_on_and_off_after(how):
    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            assert tracing()
            _solve()
    else:
        enable_tracing(True)
        assert tracing()
        _solve()
        enable_tracing(False)
    assert not tracing()
    m = solver_metrics()
    on = m.snapshot()
    n_records = len(m.spans())
    assert on["solve.n"] == 1 and n_records > 0
    _solve()
    assert m.snapshot() == on and len(m.spans()) == n_records


@pytest.mark.parametrize("method", ["vsr", "pipelined"])
def test_solve_spans_and_reads(method):
    enable_tracing(True)
    res = _solve(method)
    m = solver_metrics()
    assert res.converged and res.iterations > 0
    # the reads: the loop's i, every rr the predicate checks (the last
    # one ends the loop), the result's i and rr
    assert m.get("host_syncs") == res.iterations + 4
    assert m.get("solve.n") == 1
    if method == "vsr":
        assert m.get("solve.iter.n") == res.iterations
        assert m.get("solve.rr_read.n") == res.iterations + 1
        assert m.get("solve.init.n") == 1
    spans = m.spans()
    root = spans[0]
    assert root[0] == "solve" and root[3] is None
    for name, t0, t1, parent, rid in spans[1:]:
        assert parent == 0 and rid == root[4]
        assert root[1] <= t0 <= t1 <= root[2]
    assert m.get("solve.ns") == root[2] - root[1]
    inside = sum(t1 - t0 for _, t0, t1, _, _ in spans[1:])
    assert inside <= m.get("solve.ns")


def test_roots_get_ids_and_children_their_root():
    m = Metrics()
    enable_tracing(True)
    assert traced_metrics() is solver_metrics()
    with m.span("a"):
        with m.span("a.b"):
            with m.span("a.b.c"):
                assert traced_metrics() is m
        with m.span("a.d"):
            pass
    with m.span("e", rid=41):
        with m.span("e.f"):
            pass
    with m.span("g"):
        pass
    names = [(r[0], r[3], r[4]) for r in m.spans()]
    assert names == [("a", None, 0), ("a.b", 0, 0), ("a.b.c", 1, 0),
                     ("a.d", 0, 0), ("e", None, 41), ("e.f", 4, 41),
                     ("g", None, 1)]
    assert m.get("a.b.n") == 1 and m.get("a.ns") >= m.get("a.b.ns")
    m.reset()
    assert m.spans() == [] and m.snapshot() == {"exit_status": {}}
    assert m.clock is None


@pytest.mark.parametrize("layout,backend", [("auto", "pallas"),
                                            ("auto", "xla"),
                                            ("sell", "xla")])
def test_engine_spans(layout, backend):
    enable_tracing(True)
    eng, rids = _engine(layout, backend)
    spans = eng._metrics.spans()
    snap = eng.metrics()
    submits = [i for i, r in enumerate(spans) if r[0] == "submit"]
    assert [spans[i][4] for i in submits] == rids
    assert snap["submit.n"] == len(rids) and snap["step.n"] > 0
    assert snap["admit.grow.n"] >= 2 and snap["growths"] >= 1
    for i in submits:
        kids = [r for r in spans if r[3] == i]
        assert {r[0] for r in kids} <= SUBMIT_CHILDREN
        assert {"submit.harvest", "admit.pack", "admit.copy",
                "admit.warmup"} <= {r[0] for r in kids}
        assert all(r[4] == spans[i][4] for r in kids)
        assert sum(r[2] - r[1] for r in kids) <= spans[i][2] - spans[i][1]
    for i, r in enumerate(spans):
        if r[0] == "step":
            assert r[3] is None
            assert {k[0] for k in spans if k[3] == i} <= STEP_CHILDREN
    kids_ns = sum(snap.get(f"{k}.ns", 0) for k in SUBMIT_CHILDREN)
    assert kids_ns <= snap["submit.ns"]
    # the VM's predicate reads count in the engine's bag, not the solver's
    assert snap["host_syncs"] > 0
    assert solver_metrics().get("host_syncs") == 0
    sizes = (6, 9, 12, 7)
    assert snap["packed_nnz"] >= sum(poisson_2d(n).nnz for n in sizes)
    assert snap["packed_bytes"] > 0 and snap["h2d_bytes"] > 0
    # every result's x, at fp64, comes back
    assert snap["d2h_bytes"] >= 8 * sum(n * n for n in sizes)


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(metrics, "SPAN_CAP", 3)
    m = Metrics()
    enable_tracing(True)
    with m.span("r"):
        for _ in range(4):
            with m.span("r.c"):
                pass
    assert len(m.spans()) == 3
    assert m.get("spans_dropped") == 2
    assert m.get("r.c.n") == 4 and m.get("r.n") == 1


def test_clock_pair_places_spans_on_the_profilers_clock():
    m = Metrics()
    with record_function("warm"):             # first use costs more
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.span("wrapped"):
            with record_function("wrapped_range"):
                torch.ones(64).sum()
                time.sleep(0.005)
    (name, t0, t1, _, _), = m.spans()
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "wrapped_range"]
    perf0, wall0 = m.clock
    start, end = t0 - perf0 + wall0, t1 - perf0 + wall0
    assert abs(ev.start_ns() - start) < 1e6
    assert abs(ev.start_ns() + ev.duration_ns() - end) < 1e6


def test_counters_do_not_move_untraced():
    m = Metrics()
    m.count("host_syncs", 3)
    with m.span("x"):
        m.bump("admits")
    assert m.snapshot() == {"admits": 1, "exit_status": {}}
    enable_tracing(True)
    m.count("host_syncs", 3)
    assert m.get("host_syncs") == 3 and m.get("admits") == 1
