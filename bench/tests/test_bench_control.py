"""``correct`` fails when it should: the control (the reference one
precision down in the program's place) and each fault a cell can have,
planted in the port underneath a whole run on the CPU.

The faults: a step that returns its state unchanged; half of the work
left out (half of the rows of the SpMV, half of the engine's answers);
an answer altered where it is produced.  An exchange between chips has
no place in these one-chip cells.
"""
import time

import pytest
import torch

from harness.cell import run_cell
from test_bench_harness import SMALL, small_cell

SEED = 2 ** 31 + 23


def _run(case, **kw):
    return run_cell(small_cell(case), seed=SEED, seconds=0.3, trace=False,
                    device="cpu", t_start=time.perf_counter(), grace_s=0.5,
                    **kw)


def _failed(out):
    assert not out["correct"]
    assert any(not c["value"] <= c["limit"] for c in out["checks"].values())
    return {k for k, c in out["checks"].items()
            if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("case", sorted(SMALL))
def test_the_sound_run_passes(case):
    assert _run(case)["correct"]


# The control at the sizes a test run holds; bench/control.py runs it at
# the cells' own sizes on the card.
CONTROL_SIZE = [{"generator": "poisson_2d", "nx": 100}]


@pytest.mark.parametrize("case", ["ecology2.rhs_stream",
                                  "ecology2.engine_stream"])
def test_the_control_fails(case):
    cell = small_cell(case)
    cell.config["matrices"] = CONTROL_SIZE
    out = run_cell(cell, seed=SEED, seconds=0.3, trace=False, device="cpu",
                   t_start=time.perf_counter(), grace_s=0.5,
                   program=cell.program.Control)
    _failed(out)


# --------------------------------------------------------------- faults
def _unchanged_loop(monkeypatch):
    from repro_torch.core import phases
    monkeypatch.setattr(phases, "jpcg_loop",
                        lambda matvec, diag, state, **kw: state)


def _half_rows(monkeypatch):
    from repro_torch.kernels.ops import EllKernelOperator
    full = EllKernelOperator.matvec

    def half(self, x):
        y = full(self, x).clone()
        y[self.n // 2:] = 0
        return y

    monkeypatch.setattr(EllKernelOperator, "matvec", half)


def _altered_x(monkeypatch):
    from repro_torch.core import cg
    solve = cg.jpcg_solve

    def altered(*a, **kw):
        res = solve(*a, **kw)
        res.x[res.x.shape[0] // 2] += 1e-3 * float(res.x.abs().max())
        return res

    monkeypatch.setattr(cg, "jpcg_solve", altered)


@pytest.mark.parametrize("case", ["ecology2.rhs_stream", "mix.rhs_stream"])
@pytest.mark.parametrize("fault", [_unchanged_loop, _half_rows, _altered_x])
def test_a_fault_in_the_solve_fails(monkeypatch, case, fault):
    fault(monkeypatch)
    _failed(_run(case))


def _unchanged_step(monkeypatch):
    from repro_torch.serve.solver_engine import _Pool
    monkeypatch.setattr(_Pool, "step", lambda self: None)


def _half_answers(monkeypatch):
    from repro_torch.serve.solver_engine import _Pool
    harvest = _Pool.harvest
    monkeypatch.setattr(_Pool, "harvest", lambda self: {
        rid: r for rid, r in harvest(self).items() if rid % 2 == 0})


def _altered_answer(monkeypatch):
    from repro_torch.serve.solver_engine import _Pool
    harvest = _Pool.harvest

    def altered(self):
        done = harvest(self)
        for r in done.values():
            r.x[r.x.shape[0] // 2] += 1e-3 * float(r.x.abs().max())
        return done

    monkeypatch.setattr(_Pool, "harvest", altered)


@pytest.mark.parametrize("case", ["ecology2.engine_stream",
                                  "mix.engine_stream"])
@pytest.mark.parametrize("fault", [_unchanged_step, _half_answers,
                                   _altered_answer])
def test_a_fault_in_the_engine_fails(monkeypatch, case, fault):
    fault(monkeypatch)
    _failed(_run(case))
