"""The readers of the port's own spans and counters: a small traced run
of each cell reports them in range, a program without them (the parent
of the change that added them) reads None, and idle gaps are placed by
their midpoints."""
import time

import pytest

from harness.cell import Profile, Run, run_cell
from harness.spec import load_cell
from test_bench_harness import small_cell

ENGINE = ("admit_pack_ms.engine", "admit_copy_ms.engine",
          "admit_self_ms.engine")
SINGLE = ("host_syncs_per_iter.single", "rr_wait_pct.single",
          "idle_launch_pct.single")


@pytest.fixture(autouse=True)
def clean_solver_metrics():
    from repro_torch.core.metrics import reset_solver_metrics
    reset_solver_metrics()
    yield
    reset_solver_metrics()


def _value(out, name):
    return out["metrics"][name]["value"]


@pytest.mark.parametrize("case", ["ecology2.rhs_stream",
                                  "ecology2.engine_stream"])
def test_a_small_traced_run_reads_the_ports_spans(case):
    cell = small_cell(case)
    out = run_cell(cell, seed=2 ** 33 + 5, seconds=0.4, trace=True,
                   device="cpu", t_start=time.perf_counter())
    assert out["correct"]
    if case.endswith("engine_stream"):
        assert all(_value(out, n) > 0 for n in ENGINE)
    else:
        # one rr read an iteration, and a few a solve
        assert 1.0 <= _value(out, "host_syncs_per_iter.single") <= 1.5
        for name in ("rr_wait_pct.single", "idle_launch_pct.single"):
            assert 0.0 < _value(out, name) <= 100.0


def _bare_run(profile=None, counters=None):
    return Run(cell="c", config={}, inputs=None, setup_s=1.0, window_s=1.0,
               answers=[], spans={}, counters=counters or {},
               profile=profile)


def test_without_the_ports_spans_every_reader_reads_none():
    readers = {**load_cell("ecology2.engine_stream").readers,
               **load_cell("ecology2.rhs_stream").readers}
    prof = Profile(t0=0.0, window_s=1.0, ops=[("k", 0.0, 0.5)])
    for run in (_bare_run(), _bare_run(prof, {"admits": 3,
                                              "spmv_calls": 7})):
        for name in ENGINE + SINGLE:
            assert readers[name](run) is None, name


def _idle_launch(monkeypatch, iters, reads=()):
    """idle_launch_pct.single's reader, reading ``iters`` as the
    ``solve.iter`` records and ``reads`` as the ``solve.rr_read`` ones."""
    read = load_cell("ecology2.rhs_stream").readers["idle_launch_pct.single"]
    monkeypatch.setitem(read.__globals__, "records", lambda profile, name: (
        list(iters) if name == "solve.iter" else list(reads)))
    return read


def test_idle_gaps_are_placed_by_their_midpoints(monkeypatch):
    prof = Profile(t0=10.0, window_s=1.0,
                   ops=[("k", 0.0, 0.2), ("k", 0.5, 0.6), ("k", 0.9, 1.0)])
    # gaps 0.2-0.5 (midpoint 0.35) and 0.6-0.9 (0.75): one inside
    read = _idle_launch(monkeypatch, [(0.3, 0.4), (0.8, 0.85)])
    assert read(_bare_run(prof)) == pytest.approx(50.0)
    read = _idle_launch(monkeypatch, [(0.0, 0.34)])
    assert read(_bare_run(prof)) == pytest.approx(0.0)


@pytest.mark.parametrize("drift", [0.0, 0.01])
def test_device_times_are_placed_by_the_reads(monkeypatch, drift):
    """Device times that start late by more than an iteration, and whose
    clock drifts against the host's, are placed by the read copies, which
    fall inside their read records; the host's iterations vary in length,
    as on the card (0.51 ms, sd 0.15), so no shift by whole iterations
    fits as well."""
    late = 0.0008
    t, iters, reads, ops = 0.0, [], [], []
    for k in range(40):
        period = 0.0003 + 0.0001 * ((k * 7) % 5)
        iters.append((t, t + period - 0.00003))
        reads.append((t + period - 0.00003, t + period))
        s = t - late                      # the iteration's device work
        ops += [("spmv", s + 0.0001, s + 0.00018),
                ("Memcpy DtoH (Device -> Pinned)", s + period - 0.00002,
                 s + period - 0.000015)]
        t += period
    ops = [(n, s * (1 + drift), e * (1 + drift)) for n, s, e in ops
           if s >= 0]
    prof = Profile(t0=0.0, window_s=(t - late) * (1 + drift), ops=ops)
    read = _idle_launch(monkeypatch, iters, reads)
    copies, shifts = read.__globals__["placement"](prof, reads)
    assert shifts[0] == pytest.approx(late, abs=2e-5)
    # the last copy, about 19 ms of device time on, is placed as well
    assert copies[-1] + shifts[-1] == pytest.approx(reads[-1][1] - 1.75e-5,
                                                   abs=2e-5)
    # every gap but those around the copies lies in an iteration's span
    value = read(_bare_run(prof))
    assert value > 75.0
    assert _idle_launch(monkeypatch, iters)(_bare_run(prof)) < value
