"""Solver health + observability primitives (the torch port of
:mod:`repro.core.metrics`).

CG breaks down in two recognizable ways:

* **indefinite** — ``pAp ≤ 0``: the operand is not positive definite
  along the current search direction, so ``α = rz/pAp`` stops being a
  descent step;
* **non-finite** — ``rr``/``α``/``β`` leaves the reals.

Both engines (:mod:`repro_torch.core.batch` phases and the specialized
:mod:`repro_torch.core.vm`) evaluate :func:`tick_health` on each tick's
*candidate* values: a lane that trips a predicate **freezes that tick** —
its writes are discarded, its iteration counter does not advance, and its
``status`` latches the breakdown code.  Healthy lanes see only compares
and ``torch.where`` selects on values the tick already computed, so
detection is bit-invisible to them.

Status lattice (terminal states are latched; ``RUNNING`` is the only
non-terminal value)::

    RUNNING ──> CONVERGED              rr ≤ τ on a committed tick
            ──> MAXITER                per-lane budget exhausted
            ──> BREAKDOWN_INDEFINITE   pAp ≤ 0 on the candidate tick
            ──> BREAKDOWN_NONFINITE    rr/α/β non-finite (or rr non-
                                       finite already at warm-up)

:class:`Metrics` is the host-side counter bag used by
:class:`repro_torch.serve.SolverEngine` and (module-global instance,
:func:`solver_metrics`) by :func:`repro_torch.core.batch
.jpcg_solve_batched`.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Union

import numpy as np
import torch

__all__ = ["STATUS_RUNNING", "STATUS_CONVERGED", "STATUS_MAXITER",
           "STATUS_BREAKDOWN_INDEFINITE", "STATUS_BREAKDOWN_NONFINITE",
           "STATUS_NAMES", "BREAKDOWN_STATUSES", "status_name",
           "is_breakdown", "is_breakdown_codes", "initial_status",
           "tick_health",
           "advance_status", "finalize_status", "Metrics",
           "solver_metrics", "reset_solver_metrics"]

# ------------------------------------------------------------- status codes
#: Lane still iterating (the only non-terminal status).
STATUS_RUNNING = 0
#: ``rr ≤ τ`` on a committed tick (or already at warm-up).
STATUS_CONVERGED = 1
#: Per-lane iteration budget exhausted without convergence.
STATUS_MAXITER = 2
#: ``pAp ≤ 0`` — operand not SPD along the search direction.
STATUS_BREAKDOWN_INDEFINITE = 3
#: ``rr``/``α``/``β`` went NaN/Inf (incl. non-finite warm-up ``rr``).
STATUS_BREAKDOWN_NONFINITE = 4

STATUS_NAMES: Dict[int, str] = {
    STATUS_RUNNING: "RUNNING",
    STATUS_CONVERGED: "CONVERGED",
    STATUS_MAXITER: "MAXITER",
    STATUS_BREAKDOWN_INDEFINITE: "BREAKDOWN_INDEFINITE",
    STATUS_BREAKDOWN_NONFINITE: "BREAKDOWN_NONFINITE",
}

#: The statuses the engine's fp64 escalation policy may retry.
BREAKDOWN_STATUSES = ("BREAKDOWN_INDEFINITE", "BREAKDOWN_NONFINITE")


def status_name(code: Union[int, str]) -> str:
    """Human-readable name of a status code (names pass through)."""
    if isinstance(code, str):
        return code
    return STATUS_NAMES.get(int(code), f"UNKNOWN({int(code)})")


def is_breakdown(status: Union[int, str, None]) -> bool:
    """True iff the status (code or name) is a breakdown exit."""
    if status is None:
        return False
    return status_name(status) in BREAKDOWN_STATUSES


def is_breakdown_codes(codes) -> np.ndarray:
    """Vectorized :func:`is_breakdown` over a host array of status codes."""
    codes = np.asarray(codes)
    return ((codes == STATUS_BREAKDOWN_INDEFINITE)
            | (codes == STATUS_BREAKDOWN_NONFINITE))


# --------------------------------------------------- in-loop status algebra
def initial_status(rr, tol, *, detect: bool):
    """Warm-up status vector from the initial ``rr`` (both engines).

    ``CONVERGED`` where ``rr ≤ tol`` already holds, else ``RUNNING``;
    with ``detect`` a non-finite warm-up ``rr`` (NaN/Inf-seeded operand
    or rhs) latches ``BREAKDOWN_NONFINITE`` immediately — such a lane is
    inactive from tick 0 either way (``NaN > tol`` is False), detection
    just names the reason instead of wearing the MAXITER face.
    """
    st = torch.where(rr <= tol, STATUS_CONVERGED,
                     STATUS_RUNNING).to(torch.int32)
    if detect:
        st = torch.where(~torch.isfinite(rr), STATUS_BREAKDOWN_NONFINITE, st)
    return st


def tick_health(keep, pap, alpha, beta, rr_new, *, detect: bool):
    """Classify one tick's candidate scalars per lane.

    Returns ``(upd, bd_indef, bd_nonf)``: ``upd`` is the commit mask —
    lanes whose tick writes land (``keep`` minus fresh breakdowns);
    ``bd_*`` flag lanes that froze this tick (``None`` when ``detect``
    is off, in which case ``upd is keep`` — the caller's dataflow is
    unchanged *by construction*, which is what makes detection-off a
    bit-exact reference).  Precedence: ``pAp ≤ 0`` wins over non-finite
    (an indefinite step at exactly 0 makes ``α`` Inf in the same tick —
    the indefiniteness is the diagnosis, the Inf the symptom); NaN
    ``pAp`` fails the ``≤ 0`` compare and lands in non-finite.

    Assumes the tick computes ``pAp`` (every compiled ISA program and
    the phase engine do); a custom VM program that never writes the
    ``pap`` scalar register must run with detection off.
    """
    if not detect:
        return keep, None, None
    bd_indef = keep & (pap <= 0)
    bad = ~(torch.isfinite(rr_new) & torch.isfinite(alpha)
            & torch.isfinite(beta))
    bd_nonf = keep & ~bd_indef & bad
    return keep & ~(bd_indef | bd_nonf), bd_indef, bd_nonf


def advance_status(status, *, upd, bd_indef, bd_nonf, rr_new, tol, it,
                   maxiter_vec=None):
    """One tick's status transitions (shared by both engines).

    ``it`` is the already-advanced per-lane count; ``maxiter_vec`` is
    the per-lane budget when the loop enforces one in-loop (the serving
    steppers — solve runners bound ``k`` statically instead and map
    leftover ``RUNNING`` via :func:`finalize_status`).  Terminal states
    latch: every transition is gated on a mask that is ``False`` for
    lanes already frozen.
    """
    if bd_indef is not None:
        status = torch.where(bd_indef, STATUS_BREAKDOWN_INDEFINITE, status)
        status = torch.where(bd_nonf, STATUS_BREAKDOWN_NONFINITE, status)
    conv = upd & (rr_new <= tol)
    status = torch.where(conv, STATUS_CONVERGED, status)
    if maxiter_vec is not None:
        status = torch.where(upd & ~conv & (it >= maxiter_vec),
                             STATUS_MAXITER, status)
    return status


def finalize_status(status):
    """Map leftover ``RUNNING`` to ``MAXITER`` when a solve runner's loop
    exits — the only ways to leave the loop still ``RUNNING`` are the
    static ``k == maxiter`` bound and (detection off) a lane inactive
    since warm-up, both of which wear the budget-exhausted face."""
    return torch.where(status == STATUS_RUNNING, STATUS_MAXITER, status)


# ------------------------------------------------------------- observability
class Metrics:
    """Flat counter bag + exit-status histogram, snapshotable as a dict.

    Deliberately dumb: ``bump`` adds to named integer counters,
    ``record_exit`` feeds the status histogram, ``snapshot`` returns
    plain Python data (json-safe).  All host-side — nothing here touches
    a device tensor.
    """

    def __init__(self) -> None:
        self._counters: Counter = Counter()
        self._exits: Counter = Counter()

    def reset(self) -> None:
        self._counters.clear()
        self._exits.clear()

    def bump(self, name: str, value: int = 1) -> None:
        self._counters[name] += int(value)

    def record_exit(self, status: Union[int, str],
                    count: int = 1) -> None:
        self._exits[status_name(status)] += int(count)

    def record_exits(self, statuses) -> None:
        """Histogram a whole status vector (host array of codes)."""
        codes, counts = np.unique(np.asarray(statuses), return_counts=True)
        for c, n in zip(codes, counts):
            self.record_exit(int(c), int(n))

    def get(self, name: str) -> int:
        return int(self._counters.get(name, 0))

    @property
    def exit_histogram(self) -> Dict[str, int]:
        return dict(self._exits)

    def snapshot(self, extra: Optional[dict] = None) -> dict:
        out = {k: int(v) for k, v in sorted(self._counters.items())}
        out["exit_status"] = dict(self._exits)
        if extra:
            out.update(extra)
        return out


#: Module-global metrics fed by the solve runners
#: (:func:`repro_torch.core.batch.jpcg_solve_batched`); the serving engine owns
#: its own instance instead (``SolverEngine.metrics()``).
_GLOBAL = Metrics()


def solver_metrics() -> Metrics:
    """The process-wide solver metrics instance."""
    return _GLOBAL


def reset_solver_metrics() -> None:
    _GLOBAL.reset()
