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
.jpcg_solve_batched` and :func:`repro_torch.core.cg.jpcg_solve`.

**Spans and traced counters.**  ``Metrics.span(name, rid=None)`` times a
host-side block; ``Metrics.count(name, n)`` adds to a counter.  Both act
only while tracing is on: while a ``torch.profiler`` session runs in the
process, or after :func:`enable_tracing` ``(True)``.  Off, a span site
costs one flag check and records nothing, and no traced counter moves;
the counters above (``admits``, ``iterations``, …) count as always.  On,
a span leaves the record ``(name, t0_ns, t1_ns, parent_index, rid)`` in
:meth:`Metrics.spans`, in the order spans open (``time.perf_counter_ns``,
the benchmark's clock; spans nest through a per-thread stack,
``parent_index`` indexes the same list, ``None`` for a root; every root
gets an id — the request id on the engine's ``submit`` — which its
descendants carry), and on closing adds its duration to the counter
``"<name>.ns"`` and 1 to ``"<name>.n"``.  The list holds
at most ``SPAN_CAP`` records; past that ``spans_dropped`` counts what it
did not keep.  ``Metrics.clock`` is a ``(perf_counter_ns, time_ns)``
pair taken together at the first span recorded since the bag was made or
reset: ``t - clock[0] + clock[1]`` places a record on the clock of the
profiler's events (``kineto_results.events()[i].start_ns()``).

The spans, each under its parent (``solve.*`` in :func:`solver_metrics`,
the rest in the engine's own bag, so ``SolverEngine.metrics()`` carries
their ``.ns`` / ``.n`` counters):

* ``solve`` (``jpcg_solve``) > ``solve.init`` (warm-up SpMV and dots),
  ``solve.iter`` (enqueueing one iteration), ``solve.rr_read`` (the host
  blocked on each ``rr`` of the loop's predicate);
* ``submit`` > ``submit.harvest``, ``admit.pack`` (host packing: CSR to
  the pool's layout, the diagonal, padded b / x0), ``admit.grow``
  (first allocation, bucket or lane growth), ``admit.copy`` (host to
  device copies and slot writes), ``admit.warmup`` (the lane's warm-up);
* ``step`` > ``step.account`` (the per-lane ``it`` / ``status`` reads),
  ``step.vm`` (the stepper: ``chunk_iters`` ticks), ``step.harvest``,
  ``step.compact``.

Traced counters: ``host_syncs`` (blocking device-to-host reads on the
solve and engine paths: the loops' predicate reads, result reads, the
engine's lane reads; counted on a CPU run too, where none blocks),
``packed_nnz`` and ``packed_bytes`` (nonzeros packed and bytes of the
lane arrays built on the host at admission), ``h2d_bytes`` (host arrays
copied to the device at admission), ``d2h_bytes`` (bytes harvests copy
back).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import Counter
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.autograd import profiler as _profiler

__all__ = ["STATUS_RUNNING", "STATUS_CONVERGED", "STATUS_MAXITER",
           "STATUS_BREAKDOWN_INDEFINITE", "STATUS_BREAKDOWN_NONFINITE",
           "STATUS_NAMES", "BREAKDOWN_STATUSES", "status_name",
           "is_breakdown", "is_breakdown_codes", "initial_status",
           "tick_health",
           "advance_status", "finalize_status", "Metrics", "SPAN_CAP",
           "enable_tracing", "tracing", "traced_metrics",
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
#: Span records a :class:`Metrics` keeps at most (then ``spans_dropped``).
SPAN_CAP = 1 << 20

_explicit = [False]          # enable_tracing's switch, beside the profiler's
_OFF = nullcontext()


class _Open(threading.local):
    def __init__(self):
        #: this thread's open spans, innermost last: (bag, records, index,
        #: root id, parent index, t0_ns)
        self.spans: list = []


_open = _Open()


def enable_tracing(on: bool = True) -> None:
    """Turn tracing on (or off again) without a profiler session: spans
    and traced counters record in every :class:`Metrics` of the process."""
    _explicit[0] = bool(on)


def tracing() -> bool:
    """Whether spans and traced counters record: after
    :func:`enable_tracing`, or while a ``torch.profiler`` session runs."""
    return _explicit[0] or _profiler._is_profiler_enabled


def traced_metrics() -> "Metrics":
    """The bag of this thread's innermost open span, else
    :func:`solver_metrics`: where code shared by the solve runners and the
    engine (``core.batch._run_chunked``) counts its host reads."""
    stack = _open.spans
    return stack[-1][0] if stack else _GLOBAL


class _Span:
    """Times a block as a span of bag ``m``.  What an open span needs is
    kept on the thread's stack, so one object serves every use of a name
    (``rid`` None: the root id is drawn, or a child's inherited)."""

    __slots__ = ("m", "name", "rid", "ns", "n")

    def __init__(self, m: "Metrics", name: str, rid=None):
        self.m, self.name, self.rid = m, name, rid
        self.ns, self.n = name + ".ns", name + ".n"

    def __enter__(self):
        m, stack, rid = self.m, _open.spans, self.rid
        parent = None
        for frame in reversed(stack):           # the bag's innermost span
            if frame[0] is m:
                parent = frame[2]
                if rid is None:
                    rid = frame[3]
                break
        if rid is None:
            rid = next(m._root_ids)
        records = m._records
        if m.clock is None:
            m.clock = (time.perf_counter_ns(), time.time_ns())
        idx = next(m._slots)
        if idx < SPAN_CAP:
            records[idx] = None                  # filled in on close
        else:
            idx = None
            m.bump("spans_dropped")
        stack.append((m, records, idx, rid, parent, time.perf_counter_ns()))
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        m, records, idx, rid, parent, t0 = _open.spans.pop()
        if idx is not None:
            records[idx] = (self.name, t0, t1, parent, rid)
        c = m._counters
        c[self.ns] = c.get(self.ns, 0) + t1 - t0
        c[self.n] = c.get(self.n, 0) + 1
        return False


class Metrics:
    """Flat counter bag + exit-status histogram, snapshotable as a dict,
    and the span records of the module docstring.

    Deliberately dumb: ``bump`` adds to named integer counters,
    ``record_exit`` feeds the status histogram, ``snapshot`` returns
    plain Python data (json-safe).  All host-side — nothing here touches
    a device tensor.  ``span`` and ``count`` record only while
    :func:`tracing` holds.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, int] = {}     # a dict: faster than Counter
        self._exits: Counter = Counter()
        self._named: Dict[str, _Span] = {}
        self.reset()

    def reset(self) -> None:
        """Clear counters, exits, span records and the clock pair (a span
        open across the reset records nowhere, but still counts)."""
        self._counters.clear()
        self._exits.clear()
        self._records: Dict[int, Optional[tuple]] = {}
        self._slots = itertools.count()          # record indices, in order
        self._root_ids = itertools.count()
        #: ``(perf_counter_ns, time_ns)`` taken together at the first span
        #: recorded since the bag was made or reset; None before.
        self.clock: Optional[Tuple[int, int]] = None

    def bump(self, name: str, value: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + int(value)

    def count(self, name: str, value: int = 1) -> None:
        """``bump``, only while tracing is on."""
        if _explicit[0] or _profiler._is_profiler_enabled:
            self.bump(name, value)

    def span(self, name: str, rid=None):
        """A context manager timing a block as the span ``name`` (a root
        gets ``rid``, or the next id of this bag; a child its root's),
        only while tracing is on; otherwise a shared no-op."""
        if not (_explicit[0] or _profiler._is_profiler_enabled):
            return _OFF
        if rid is not None:
            return _Span(self, name, rid)
        sp = self._named.get(name)
        if sp is None:
            sp = self._named[name] = _Span(self, name)
        return sp

    def spans(self) -> List[Optional[tuple]]:
        """The span records ``(name, t0_ns, t1_ns, parent_index, rid)`` in
        the order the spans opened; a span still open reads None."""
        records = self._records
        return [records.get(i) for i in range(len(records))]

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
