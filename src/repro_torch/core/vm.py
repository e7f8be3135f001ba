"""Batched stream VM, specialized path — the torch port of
:mod:`repro.core.vm`.

The VM executes a stream-ISA program (:mod:`repro_torch.core.compile`) for
G independent systems at once: ``mem`` holds the vector buffers (x r p ap
M b) as ``[6, G, n]``, ``queues`` the inter-module streams as
``[8, G, n]``, ``sregs`` the scalar registers as ``[6, G]``.  One tick runs
the program once — one JPCG iteration per lane — and every write to
``mem``/``queues``/``sregs`` is gated on the lane's commit mask exactly as
in the phases engine (:func:`repro_torch.core.batch._batched_body`), so
the VM is bitwise equal to it.

Two paths share these semantics, as in the reference:

* **specialized** (``program=`` given to the factory): the program is
  decoded once when the runner is built (:func:`_analyze_program`) and run
  word by word as straight-line torch ops with static buffer/queue
  indices (:func:`_run_specialized`).  Only the buffers the program
  touches and the queues it reads before writing are carried between
  ticks; the rest pass through untouched.  Runners and steppers are
  cached per program bytes.
* **generic** (``program=None``, ``specialize=False`` at the front
  doors): the program is an operand of every call — any program of the
  ISA, paper policy, min-traffic, plain CG or a custom one, through one
  cached runner or stepper per bucket, never per program.  It stays on
  the host as ``int32[P, 8]`` numpy and is decoded once per call
  (:func:`_decode`), so no word costs a device read; each tick runs it
  through the per-instruction executor (:func:`_make_executor`) on copies
  of the whole ``mem`` and ``queues`` files and commits both, and
  ``sregs``, gated on the tick's commit mask (:func:`_vm_body`).  The
  arithmetic is the specialized path's op for op, so the two are bitwise
  equal.

The tick updates the state's tensors **in place** (``torch.where(...,
out=)``) — the torch spelling of the reference's buffer donation: a
runner owns the state it creates, and a stepper either consumes the
state it is given (``donate=True``, the serving engine) or works on a
copy.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.batch import (_cached, _masked_trace, _matvec_factory,
                                    _row_dot, _run_chunked, _shard_args,
                                    _unshard)
from repro_torch.core.compile import executable_key
from repro_torch.core.isa import (CTRL_ALPHA, ITYPE_COMP, ITYPE_CTRL,
                                  ITYPE_NOP, ITYPE_VCTRL, SREG)
from repro_torch.core.metrics import (advance_status, finalize_status,
                                      initial_status, tick_health)
from repro_torch.core.precision import get_scheme

__all__ = ["BatchedVMState", "vm_init", "clone_state", "make_vm_runner",
           "make_vm_stepper", "vm_executable_stats", "vm_solve"]

_N_QUEUES = 8
_N_SREGS = 6

#: COMP module id -> executor branch (0=spmv, 1=dot, 2=axpy, 3=div).
_BRANCH_OF_MOD = (0, 1, 2, 2, 3, 1, 2, 1)


class BatchedVMState(NamedTuple):
    """Lane-batched VM state; every tensor's lane axis is G."""

    k: torch.Tensor        # global tick (int32 scalar)
    it: torch.Tensor       # int32[G] per-lane iteration counts
    status: torch.Tensor   # int32[G] exit codes (metrics.STATUS_*)
    mem: torch.Tensor      # [6, G, n] vector buffers (x r p ap M b)
    queues: torch.Tensor   # [8, G, n] inter-module streams
    sregs: torch.Tensor    # [6, G] scalar registers (α β rz rr pap rz')
    active: torch.Tensor   # bool[G] live-lane mask
    trace: torch.Tensor    # [G, maxiter] rr per iteration, or [G, 0]


def vm_init(matvec, diag, b, x0, *, maxiter: int, with_trace: bool,
            tol, detect: bool = True) -> BatchedVMState:
    """Controller warm-up (paper Alg. 1 lines 1–5) — arithmetic identical
    to :func:`repro_torch.core.batch._batched_init`, packed into VM
    buffers."""
    vd, dev = b.dtype, b.device
    G = b.shape[0]
    r = b - matvec(x0)
    z = r / diag
    rz = _row_dot(r, z)
    rr = _row_dot(r, r)
    mem = torch.stack([x0, r, z, torch.zeros_like(r), diag, b])
    sregs = torch.zeros((_N_SREGS, G), dtype=vd, device=dev)
    sregs[SREG["rz"]] = rz
    sregs[SREG["rr"]] = rr
    return BatchedVMState(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        it=torch.zeros(G, dtype=torch.int32, device=dev),
        status=initial_status(rr, tol, detect=detect), mem=mem,
        queues=torch.zeros((_N_QUEUES,) + tuple(r.shape), dtype=vd,
                           device=dev),
        sregs=sregs, active=rr > tol,
        trace=torch.zeros((G, maxiter if with_trace else 0), dtype=vd,
                          device=dev))


def clone_state(st: BatchedVMState) -> BatchedVMState:
    return BatchedVMState(*(t.clone() for t in st))


def _commit(st: BatchedVMState, n_sregs, upd, keep, bd_i, bd_n, rr_cand,
            tol, maxiter_vec, detect, go) -> BatchedVMState:
    """The tick's bookkeeping after its state writes, in place: scalar
    registers, counters, trace, status and liveness (shared by both
    paths, as :func:`repro_torch.core.batch._batched_body` does it)."""
    torch.where(upd[None, :], n_sregs, st.sregs, out=st.sregs)
    st.it.add_(upd.to(torch.int32))
    _masked_trace(st.trace, st.k, upd, rr_cand)
    live = st.sregs[SREG["rr"]] > tol
    if maxiter_vec is not None:
        live = live & (st.it < maxiter_vec)
    if detect:
        live = live & ~(bd_i | bd_n)
    st.status.copy_(advance_status(
        st.status, upd=upd, bd_indef=bd_i, bd_nonf=bd_n, rr_new=rr_cand,
        tol=tol, it=st.it, maxiter_vec=maxiter_vec))
    # a no-op tick (go=False) must not re-evaluate liveness
    torch.where(keep, live, st.active, out=st.active)
    st.k.add_(go.to(torch.int32))
    return st


def _health(st: BatchedVMState, n_sregs, bound, detect):
    """``(go, keep, upd, bd_i, bd_n, rr_cand)`` of a tick: ``detect``
    reads the candidate ``pap``/``alpha``/``beta``/``rr`` registers (every
    canonical program writes them; a program that does not runs with
    ``detect=False``)."""
    go = st.active.any()
    if bound is not None:
        go = go & (st.k < bound)
    keep = st.active & go
    rr_cand = n_sregs[SREG["rr"]]
    upd, bd_i, bd_n = tick_health(
        keep, n_sregs[SREG["pap"]], n_sregs[SREG["alpha"]],
        n_sregs[SREG["beta"]], rr_cand, detect=detect)
    return go, keep, upd, bd_i, bd_n, rr_cand


# ------------------------------------------------------------ generic path
def _decode(program) -> Tuple[Tuple[int, ...], ...]:
    """The program operand, ``int32[P, 8]`` on the host, as Python ints:
    one decode per call, so the tick reads nothing from the device per
    word."""
    prog = np.asarray(program)
    if prog.ndim != 2 or prog.shape[1] != 8:
        raise ValueError(f"a program is int32[P, 8] words, got shape "
                         f"{prog.shape}")
    return tuple(tuple(int(v) for v in w) for w in prog.astype(np.int32))


def _make_executor(matvec):
    """Per-instruction executor closed over the batched SpMV closure:
    ``execute(word, mem, queues, s)`` writes one word's results into the
    tick's working copies ``mem`` [6, G, n] / ``queues`` [8, G, n] and the
    scalar-register list ``s`` (``[G]`` tensors), in place."""

    def exec_vctrl(w, mem, queues, s):
        buf, rd, wr, qa, qd = w[1], w[2], w[3], w[4], w[6]
        # rd: queue[qd] <- mem[buf] ; wr: mem[buf] <- queue[qa].  A word
        # that does both sees pre-instruction state: the wr reads the
        # queue before the rd writes, the rd the buffer as it was.
        src_m = mem[buf].clone() if (rd and wr) else mem[buf]
        if wr:
            mem[buf].copy_(queues[qa])
        if rd:
            queues[qd].copy_(src_m)

    def exec_comp(w, mem, queues, s):
        mod, neg, qa, qb, qd, sr = w[1], w[2], w[4], w[5], w[6], w[7]
        kind = _BRANCH_OF_MOD[mod]
        a = queues[qa]
        if kind == 0:                    # M1: SpMV
            queues[qd].copy_(matvec(a))
        elif kind == 1:                  # M2/M6/M8: row-wise dot -> sreg
            s[sr] = _row_dot(a, queues[qb])
        elif kind == 2:                  # M3/M4/M7: dst = a ± s·b
            sc = -s[sr] if neg else s[sr]
            queues[qd].copy_(a + sc[:, None] * queues[qb])
        else:                            # M5: dst = a / b
            queues[qd].copy_(a / queues[qb])

    def exec_ctrl(w, mem, queues, s):
        if w[1] == CTRL_ALPHA:           # α = rz / pap
            s[SREG["alpha"]] = s[SREG["rz"]] / s[SREG["pap"]]
        else:                            # β = rz'/rz ; rz ← rz'
            s[SREG["beta"]] = s[SREG["rz_new"]] / s[SREG["rz"]]
            s[SREG["rz"]] = s[SREG["rz_new"]]

    def exec_nop(w, mem, queues, s):
        pass

    table = {ITYPE_VCTRL: exec_vctrl, ITYPE_COMP: exec_comp,
             ITYPE_CTRL: exec_ctrl, ITYPE_NOP: exec_nop}

    def execute(w, mem, queues, s):
        try:
            fn = table[w[0]]
        except KeyError:
            raise ValueError(f"unknown instruction type {w[0]}") from None
        fn(w, mem, queues, s)

    return execute


def _vm_body(words, matvec, tol, maxiter_vec=None, *, bound=None,
             detect=True):
    """Generic VM tick, in place on the state's tensors: the decoded
    ``words`` run once on copies of ``mem``, ``queues`` and ``sregs``,
    then every one of the three is committed whole, gated on the lane's
    commit mask — a frozen lane's buffers, streams and registers do not
    drift.  ``bound``/``detect`` as in :func:`_spec_body`."""
    execute = _make_executor(matvec)

    def body(st: BatchedVMState) -> BatchedVMState:
        mem, queues = st.mem.clone(), st.queues.clone()
        s = list(st.sregs.unbind(0))
        for w in words:
            execute(w, mem, queues, s)
        n_sregs = torch.stack(s)
        go, keep, upd, bd_i, bd_n, rr_cand = _health(st, n_sregs, bound,
                                                     detect)
        kv = upd[None, :, None]
        torch.where(kv, mem, st.mem, out=st.mem)
        torch.where(kv, queues, st.queues, out=st.queues)
        return _commit(st, n_sregs, upd, keep, bd_i, bd_n, rr_cand, tol,
                       maxiter_vec, detect, go)

    return body


# -------------------------------------------------------- specialized path
class _ProgramPlan(NamedTuple):
    """Decoded program + the state it touches: ``carried_bufs`` (buffers
    read or written) and ``live_queues`` (queues read before written) are
    the loop-carried state; everything else passes through untouched."""

    ops: Tuple[Tuple[int, ...], ...]   # decoded words (python ints)
    read_bufs: Tuple[int, ...]
    written_bufs: Tuple[int, ...]
    carried_bufs: Tuple[int, ...]      # read ∪ written
    live_queues: Tuple[int, ...]       # queues read before first write
    written_queues: Tuple[int, ...]


def _analyze_program(program: np.ndarray) -> _ProgramPlan:
    """Decode a concrete program and compute the state it touches."""
    ops = tuple(tuple(int(v) for v in w)
                for w in np.asarray(program, np.int32))
    rb, wb, wq, live = set(), set(), set(), set()

    def read_queue(q):
        if q not in wq:                  # first access is a read: live-in
            live.add(q)

    for w in ops:
        if w[0] == ITYPE_VCTRL:
            # a combined rd+wr word sees pre-instruction state: account
            # the queue read before the queue write
            if w[3]:                     # wr: queue[qa] -> mem[buf]
                read_queue(w[4])
                wb.add(w[1])
            if w[2]:                     # rd: mem[buf] -> queue[qd]
                rb.add(w[1])
                wq.add(w[6])
        elif w[0] == ITYPE_COMP:
            kind = _BRANCH_OF_MOD[w[1]]
            read_queue(w[4])             # qa
            if kind != 0:                # dot / axpy / div read qb too
                read_queue(w[5])
            if kind != 1:                # spmv / axpy / div write qd
                wq.add(w[6])
    return _ProgramPlan(ops=ops, read_bufs=tuple(sorted(rb)),
                        written_bufs=tuple(sorted(wb)),
                        carried_bufs=tuple(sorted(rb | wb)),
                        live_queues=tuple(sorted(live)),
                        written_queues=tuple(sorted(wq)))


def _run_specialized(plan: _ProgramPlan, matvec, mem: dict, queues: dict,
                     sregs: torch.Tensor):
    """Execute the program once, straight-line, with static indices.

    ``mem``/``queues`` map buffer / queue ids to ``[G, n]`` tensors; the
    inputs are never written (moves rebind dict entries, every op makes a
    new tensor).  Returns ``(mem, queues, sregs)`` with ``sregs`` a new
    ``[6, G]`` tensor.
    """
    mem = dict(mem)
    queues = dict(queues)
    s = list(sregs.unbind(0))
    for w in plan.ops:
        if w[0] == ITYPE_VCTRL:
            buf, rd, wr, qa, qd = w[1], w[2], w[3], w[4], w[6]
            src_m = mem[buf]             # pre-instruction snapshots: a
            src_q = queues.get(qa)       # combined rd+wr word sees old state
            if wr:
                mem[buf] = src_q
            if rd:
                queues[qd] = src_m
        elif w[0] == ITYPE_COMP:
            mod, neg, qa, qb, qd, sr = w[1], w[2], w[4], w[5], w[6], w[7]
            kind = _BRANCH_OF_MOD[mod]
            a = queues[qa]
            if kind == 0:                # M1: SpMV
                queues[qd] = matvec(a)
            elif kind == 1:              # M2/M6/M8: row-wise dot -> sreg
                s[sr] = _row_dot(a, queues[qb])
            elif kind == 2:              # M3/M4/M7: dst = a ± s·b
                sc = -s[sr] if neg else s[sr]
                queues[qd] = a + sc[:, None] * queues[qb]
            else:                        # M5: dst = a / b
                queues[qd] = a / queues[qb]
        elif w[0] == ITYPE_CTRL:
            if w[1] == CTRL_ALPHA:       # α = rz / pap
                s[SREG["alpha"]] = s[SREG["rz"]] / s[SREG["pap"]]
            else:                        # β = rz'/rz ; rz ← rz'
                s[SREG["beta"]] = s[SREG["rz_new"]] / s[SREG["rz"]]
                s[SREG["rz"]] = s[SREG["rz_new"]]
        # NOP words do nothing
    return mem, queues, torch.stack(s)


def _spec_body(plan: _ProgramPlan, matvec, tol, maxiter_vec=None, *,
               bound=None, detect=True):
    """Specialized VM tick, in place on the state's tensors — the masking
    of :func:`repro_torch.core.batch._batched_body` applied per carried
    buffer / live queue; ``bound`` makes it self-gating for chunked
    execution; ``detect`` classifies the candidate scalar registers
    through :func:`~repro_torch.core.metrics.tick_health`."""
    wb = frozenset(plan.written_bufs)
    wq = frozenset(plan.written_queues)

    def body(st: BatchedVMState) -> BatchedVMState:
        m_in = {i: st.mem[i] for i in plan.carried_bufs}
        q_in = {q: st.queues[q] for q in plan.live_queues}
        n_mem, n_q, n_sregs = _run_specialized(plan, matvec, m_in, q_in,
                                               st.sregs)
        go, keep, upd, bd_i, bd_n, rr_cand = _health(st, n_sregs, bound,
                                                     detect)
        # Commit in place.  A new value that is itself a carried tensor
        # (a bare buffer/queue move) is copied first, so no commit reads
        # a tensor an earlier commit of this tick already overwrote.
        olds = [*m_in.values(), *q_in.values()]
        commits = [(n_mem[i], m_in[i]) for i in plan.carried_bufs if i in wb]
        commits += [(n_q[q], q_in[q]) for q in plan.live_queues if q in wq]
        kv = upd[:, None]
        commits = [(new.clone() if any(new is o for o in olds) else new, old)
                   for new, old in commits]
        for new, old in commits:
            torch.where(kv, new, old, out=old)
        return _commit(st, n_sregs, upd, keep, bd_i, bd_n, rr_cand, tol,
                       maxiter_vec, detect, go)

    return body


# -------------------------------------------------------------- runners
def make_vm_runner(*, backend, scheme, maxiter, with_trace, layout=None,
                   groups=None, block_rows=None, col_tile=None,
                   n_col_tiles=None,
                   steps_per_sync: int = 8, detect: bool = True,
                   program: Optional[np.ndarray] = None, mesh=None):
    """Solve-to-completion VM runner for one bucket.

    With ``program=None`` (the generic path) it is
    ``run(program, mat, diag, b, x0, tol) -> BatchedVMState``: the program
    is an operand, so a caller caches the runner per bucket and never per
    program.  With a concrete ``program`` (specialized) it is
    ``run(mat, diag, b, x0, tol)`` and the caller keys its cache on the
    program bytes too.  ``steps_per_sync`` ticks run per host read of the
    termination predicate (bit-identical for any value); leftover
    ``RUNNING`` statuses finalize to ``MAXITER``.  With a ``mesh``
    (:mod:`repro_torch.core.shard`) the operands are the
    :class:`~repro_torch.core.shard.Shards` that ``place_lanes`` lays out
    and the result is one state per lane shard, bit for bit the unsharded
    run's lanes.  ``block_rows`` is checked against an ELLPACK operand's
    tile rows and raises ``ValueError`` on a mismatch (row-ELL and SELL
    operands have no row tiles: there it is ignored, as in the reference).
    """
    scheme = get_scheme(scheme)
    matvec_of = _matvec_factory(backend=backend, scheme=scheme,
                                layout=layout, groups=groups,
                                block_rows=block_rows, col_tile=col_tile,
                                n_col_tiles=n_col_tiles)

    def cond(s):
        return (s.k < maxiter) & s.active.any()

    def solve(make_tick, mat, diag, b, x0, tol):
        states, ticks = [], []
        for m, d, b_s, x_s, t in _shard_args(mesh, (mat, diag, b, x0, tol)):
            matvec = matvec_of(m)
            states.append(vm_init(matvec, d, b_s, x_s, maxiter=maxiter,
                                  with_trace=with_trace, tol=t,
                                  detect=detect))
            ticks.append(make_tick(matvec, t))
        out = _run_chunked([cond] * len(states), ticks, states,
                           steps=steps_per_sync)
        return _unshard(mesh, [o._replace(status=finalize_status(o.status))
                               for o in out])

    if program is None:
        def run_generic(program, mat, diag, b, x0, tol):
            words = _decode(program)
            return solve(lambda matvec, tol: _vm_body(
                words, matvec, tol, bound=maxiter, detect=detect),
                mat, diag, b, x0, tol)

        return run_generic

    plan = _analyze_program(program)

    def run(mat, diag, b, x0, tol):
        return solve(lambda matvec, tol: _spec_body(
            plan, matvec, tol, bound=maxiter, detect=detect),
            mat, diag, b, x0, tol)

    return run


def make_vm_stepper(*, backend, scheme, bucket, chunk, layout=None,
                    groups=None, index_bytes=None, block_rows=None,
                    col_tile=None, n_col_tiles=None, steps_per_sync: int = 8,
                    donate: bool = False, detect: bool = True,
                    program: Optional[np.ndarray] = None, mesh=None):
    """Bounded VM stepper for incremental serving (``SolverEngine``): each
    call runs at most ``chunk`` ticks; per-lane budgets come in as
    ``maxiter_vec``.

    * ``program=None`` — generic:
      ``step(program, mat, state, tol, maxiter_vec) -> state``, cached per
      (backend, scheme, bucket, chunk, …) and **not** per program, so
      pools that differ only in policy share one stepper;
    * a concrete ``program`` — specialized:
      ``step(mat, state, tol, maxiter_vec) -> state``, cached per program
      bytes as well.

    ``donate=True`` consumes ``state``: it is updated in place and
    returned.  Otherwise the stepper works on a copy.  With a ``mesh``
    ``mat``, ``state``, ``tol`` and ``maxiter_vec`` are
    :class:`~repro_torch.core.shard.Shards` (``place_lanes``,
    ``place_vm_state``), and so is the returned state; the mesh signature
    joins the cache key.  ``block_rows`` is checked as
    :func:`make_vm_runner` checks it, and joins the key when given.
    """
    scheme = get_scheme(scheme)
    inner = max(1, min(int(steps_per_sync), int(chunk)))
    key_kw = dict(backend=backend, scheme=scheme.name, bucket=bucket,
                  layout=layout, index_bytes=index_bytes, chunk=chunk,
                  steps_per_sync=inner, donate=donate, detect=detect,
                  mesh=mesh, block_rows=block_rows)
    matvec_of = _matvec_factory(backend=backend, scheme=scheme,
                                layout=layout, groups=groups,
                                block_rows=block_rows, col_tile=col_tile,
                                n_col_tiles=n_col_tiles)

    def advance(make_tick, mat, state, tol, maxiter_vec):
        states, ticks, conds = [], [], []
        for m, st, t, mv in _shard_args(mesh, (mat, state, tol,
                                               maxiter_vec)):
            if not donate:
                st = clone_state(st)
            start = st.k.clone()
            ticks.append(make_tick(matvec_of(m), t, mv, start + chunk))
            conds.append(lambda s, start=start:
                         ((s.k - start) < chunk) & s.active.any())
            states.append(st)
        return _unshard(mesh, _run_chunked(conds, ticks, states,
                                           steps=inner))

    if program is None:
        def step_generic(program, mat, state, tol, maxiter_vec):
            words = _decode(program)
            return advance(lambda matvec, tol, mv, bound: _vm_body(
                words, matvec, tol, mv, bound=bound, detect=detect),
                mat, state, tol, maxiter_vec)

        return _cached(executable_key("vm_step", **key_kw),
                       lambda: step_generic)

    prog = np.asarray(program, np.int32)

    def make_spec():
        plan = _analyze_program(prog)

        def step(mat, state, tol, maxiter_vec):
            return advance(lambda matvec, tol, mv, bound: _spec_body(
                plan, matvec, tol, mv, bound=bound, detect=detect),
                mat, state, tol, maxiter_vec)

        return step

    return _cached(executable_key("vm_step_spec", program=prog, **key_kw),
                   make_spec)


def vm_executable_stats() -> dict:
    """VM runners and steppers in the batch runner cache
    (:func:`repro_torch.core.batch.batch_cache_info`): ``specialized``
    counts the program-keyed ones (``vm_*_spec``, one per distinct program
    bytes per bucket), ``generic`` the program-as-operand ones (one per
    bucket, whatever programs they run).  The reference's ``traces``
    (jit cache entries) has no counterpart: nothing here is traced."""
    from repro_torch.core.batch import _CACHE
    spec = gen = 0
    for k in _CACHE:
        if not (isinstance(k, tuple) and k and str(k[0]).startswith("vm_")):
            continue
        if str(k[0]).endswith("_spec"):
            spec += 1
        else:
            gen += 1
    return {"executables": spec + gen, "specialized": spec, "generic": gen}


def vm_solve(a, b=None, x0=None, *, program: np.ndarray, tol: float = 1e-12,
             maxiter: int = 20_000, scheme="mixed_v3",
             block_rows: int = 256, col_tile: int = 512,
             backend: str = "xla", specialize: bool = True,
             device=None) -> dict:
    """Solve Ax=b by executing ``program`` on the stream VM (a batch of
    one): :func:`repro_torch.core.batch.jpcg_solve_batched` with
    ``engine="vm"``; ``specialize=False`` takes the generic path."""
    from repro_torch.core.batch import jpcg_solve_batched
    res = jpcg_solve_batched(
        [a], None if b is None else [b], None if x0 is None else [x0],
        tol=tol, maxiter=maxiter, scheme=scheme, backend=backend,
        engine="vm", program=program, specialize=specialize,
        block_rows=block_rows, col_tile=col_tile, device=device)[0]
    return {"x": res.x, "iterations": res.iterations, "rr": res.rr,
            "converged": res.converged}

