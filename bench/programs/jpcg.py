"""The solver: Jacobi-preconditioned CG on sparse SPD systems, the system
under test of every cell whose configuration has ``"program": "jpcg"``.

What a program module gives the harness (``bench/programs/<name>.py``):

* ``make_inputs(config, seed, device, root)``: the inputs, made by the
  benchmark and handed alike to the program and to the check;
* ``Port(config, traffic, device)``: the program, ``repro_torch``'s entry
  points as a user calls them, behind the calls the mix's entry makes;
* ``Control(config, traffic, device)``: the plain reference in its place
  one precision below the configuration's, which the check has to find
  not correct (``bench/control.py``);
* ``judge(cell, inputs, answers, missing, seed, device)``: ``(correct,
  failed, checks)``.

Here the inputs are the configuration's ``matrices`` and right-hand
sides: request ``k`` is matrix ``matrix_of(k)`` (the matrices in an order
drawn from the seed, over and over: every seed sends each matrix as
often) with ``b_k`` of unit-variance normal entries drawn on the run's
device from ``(seed, k)`` alone, and ``x0`` is 0.  The calls, for the
``solve`` and ``engine`` entries: ``operator(csr)`` and ``solve(op, b) ->
Result``; ``engine()``, with ``submit(csr, b) -> request id`` (b on the
host), ``step() -> {request id: Result}`` and ``counters()``.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from harness.matrices import Csr, make_matrices
from harness.roofline import SCHEMES
from harness.traffic import derive_seed
from reference.jpcg import RefMatrix, Result, jpcg, residual_rr

__all__ = ["Inputs", "make_inputs", "Port", "Control", "judge"]

REQUESTS, ORDER, SAMPLE = 1, 4, 3      # the seed's streams


class Inputs:
    """The matrices, and request ``k``'s matrix and right-hand side."""

    def __init__(self, matrices: List[Csr], seed: int, device):
        self.matrices, self.seed = matrices, seed
        self.device = torch.device(device)
        self.order = np.random.default_rng(derive_seed(seed, ORDER)) \
            .permutation(len(matrices)).tolist()

    def matrix_of(self, k: int) -> int:
        return self.order[k % len(self.order)]

    def rhs_for(self, m: int, k: int, device, stream: int = REQUESTS):
        """``b`` of request ``k`` of ``stream``, sized for matrix ``m``:
        drawn on the run's device, handed over on ``device``."""
        g = torch.Generator(device=self.device)
        g.manual_seed(derive_seed(self.seed, stream, k))
        b = torch.randn(self.matrices[m].n, generator=g, dtype=torch.float64,
                        device=self.device)
        return b.to(device)

    def request(self, k: int, device) -> tuple:
        """``(matrix index, b)`` of request ``k``."""
        m = self.matrix_of(k)
        return m, self.rhs_for(m, k, device)


def make_inputs(config: dict, seed: int, device, root) -> Inputs:
    return Inputs(make_matrices(config, root), seed, device)


class Port:
    """``repro_torch`` as configured: ``jpcg_solve`` on an operator built
    once by ``ell_operator_pallas``, or a ``SolverEngine``."""

    def __init__(self, config: dict, traffic: dict, device):
        self.cfg, self.traffic, self.device = config, traffic, device

    def _csr(self, csr):
        from repro_torch.sparse.csr import CSRMatrix
        return CSRMatrix(indptr=csr.indptr, indices=csr.indices,
                         data=csr.data, shape=(csr.n, csr.n))

    def operator(self, csr):
        from repro_torch.kernels.ops import ell_operator_pallas
        return ell_operator_pallas(self._csr(csr), self.cfg["scheme"],
                                   device=self.device)

    def solve(self, op, b: torch.Tensor) -> Result:
        from repro_torch.core.cg import jpcg_solve
        c = self.cfg
        res = jpcg_solve(op, b, scheme=c["scheme"], tol=c["tol"],
                         maxiter=c["maxiter"], method=c["method"],
                         backend=c["backend"], device=self.device)
        status = ("CONVERGED" if res.converged else
                  "MAXITER" if res.iterations >= c["maxiter"] else
                  "STOPPED")
        return Result(x=res.x, iterations=res.iterations, status=status)

    def engine(self):
        return _PortEngine(self)


class _PortEngine:
    def __init__(self, port: Port):
        from repro_torch.serve import SolverEngine, SolverEngineConfig
        c, t = port.cfg, port.traffic
        self.eng = SolverEngine(SolverEngineConfig(
            batch_slots=t["batch_slots"], chunk_iters=t["chunk_iters"],
            scheme=c["scheme"], tol=c["tol"], maxiter=c["maxiter"],
            backend=c["backend"], device=str(port.device)))
        self.port = port

    def submit(self, csr, b) -> int:
        # the client's matrix, as it would send it: the engine packs it
        # at every admission
        return self.eng.submit(self.port._csr(csr), b.numpy())

    def step(self) -> Dict[int, Result]:
        # every result harvested since the last call, those a submit
        # harvested included
        self.eng.step()
        done = self.eng.results
        return {rid: Result(x=r.x, iterations=r.iterations, status=r.status)
                for rid, r in ((rid, done.pop(rid)) for rid in list(done))}

    def counters(self) -> dict:
        return {k: v for k, v in self.eng.metrics().items()
                if isinstance(v, int)}


class Control:
    """The reference in the program's place, its vectors one precision
    below the configuration's (fp32 for fp64): a solve is :func:`jpcg`,
    an engine tick solves one admitted system whole."""

    LOWER = {"float64": "float32"}

    def __init__(self, config: dict, traffic: dict, device):
        mat, _, _, vec = SCHEMES[config["scheme"]]
        self.vector_dtype = self.LOWER[vec]
        self.matrix_dtype = self.LOWER.get(mat, mat)
        self.cfg, self.device = config, device

    def operator(self, csr) -> RefMatrix:
        return RefMatrix(csr.indptr, csr.indices, csr.data, csr.diagonal(),
                         matrix_dtype=self.matrix_dtype,
                         vector_dtype=self.vector_dtype, device=self.device)

    def solve(self, op: RefMatrix, b: torch.Tensor) -> Result:
        return jpcg(op, b, tol=self.cfg["tol"], maxiter=self.cfg["maxiter"])

    def engine(self):
        return _ControlEngine(self)


class _ControlEngine:
    def __init__(self, control: Control):
        self.control, self.ops, self.queue, self.next = control, {}, [], 0

    def submit(self, csr, b) -> int:
        if id(csr) not in self.ops:
            self.ops[id(csr)] = self.control.operator(csr)
        self.queue.append((self.next, self.ops[id(csr)], b))
        self.next += 1
        return self.next - 1

    def step(self) -> Dict[int, Result]:
        if not self.queue:
            return {}
        rid, op, b = self.queue.pop(0)
        return {rid: self.control.solve(op, b)}

    def counters(self) -> dict:
        return {}


def judge(cell, inputs: Inputs, answers: list, missing: int, seed: int,
          device) -> tuple:
    """Hold every answer to the reference; ``(correct, failed, checks)``.

    Every answer: its status is CONVERGED and its x solves its system,
    ``‖b − A x‖²`` by the reference's SpMV.  A sample drawn from the seed,
    the answer that took the most iterations in it: the reference's own
    solve of the same system, whose iterations and x the answer's are
    compared with.
    """
    mat, _, _, vec = SCHEMES[cell.config["scheme"]]
    refs: Dict[int, RefMatrix] = {}

    def ref(m: int) -> RefMatrix:
        if m not in refs:
            a = inputs.matrices[m]
            refs[m] = RefMatrix(a.indptr, a.indices, a.data, a.diagonal(),
                                matrix_dtype=mat, vector_dtype=vec,
                                device=device)
        return refs[m]

    tol, maxiter = cell.config["tol"], cell.config["maxiter"]
    limits = {"missing": 0, "bad_status": 0, **cell.limits}

    def over(name: str, value) -> bool:
        return not value <= limits.get(name, math.inf)

    bad = [a.result.status != "CONVERGED" for a in answers]
    rr = []
    for a in answers:
        m, b = inputs.request(a.k, device)
        v = residual_rr(ref(m), a.result.x, b)
        rr.append(v if math.isfinite(v) else math.inf)
    bad = [b or over("true_rr_max", v) for b, v in zip(bad, rr)]
    order = np.random.default_rng(derive_seed(seed, SAMPLE)).permutation(
        len(answers)).tolist()
    if answers:
        longest = max(range(len(answers)),
                      key=lambda i: answers[i].result.iterations)
        order = [longest] + [i for i in order if i != longest]
    gaps, errs = [], []
    for i in order[:cell.traffic["reference_sample"]]:
        a = answers[i]
        m, b = inputs.request(a.k, device)
        want = jpcg(ref(m), b, tol=tol, maxiter=maxiter)
        x = a.result.x.to(ref(m).device, ref(m).dtype)
        gap = abs(a.result.iterations - want.iterations)
        err = float(torch.linalg.vector_norm(x - want.x)
                    / torch.linalg.vector_norm(want.x))
        err = err if math.isfinite(err) else math.inf
        gaps.append(gap)
        errs.append(err)
        bad[i] = (bad[i] or want.status != "CONVERGED"
                  or over("iter_gap_max", gap) or over("x_err_max", err))
    numbers = {"missing": missing, "bad_status": sum(
        a.result.status != "CONVERGED" for a in answers),
        "true_rr_max": max(rr, default=math.inf),
        "iter_gap_max": max(gaps, default=math.inf),
        "x_err_max": max(errs, default=math.inf)}
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    correct = bool(answers) and not any(over(k, c["value"])
                                        for k, c in checks.items())
    return correct, sum(bad) + missing, checks
