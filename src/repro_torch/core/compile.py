"""Schedule→program compiler (a copy of :mod:`repro.core.compile`).

:func:`compile_schedule` lowers a :class:`~repro_torch.core.vsr.VSRSchedule`
to the ``int32[P, 8]`` stream-ISA word array the batched VM
(:mod:`repro_torch.core.vm`) executes, in two passes per phase:

1. **List scheduling** (:func:`_schedule_events`) — dot modules first (the
   M8 hoist so ``rr`` exists early), then pending stores, then remaining
   modules preferring operands already streaming.
2. **Queue allocation** (:func:`_emit_phase`) — 8 stream queues from a
   fresh counter per phase, recycled LIFO; a value read by a gather-ordered
   (heavy) module is private, any other read is shareable.

Every compiled program is validated against its schedule's per-phase
read/write plan.  :func:`canonical_program` pads every policy to one
shared length; the port's programs are word-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.isa import (BUF, ITYPE_COMP, ITYPE_CTRL, ITYPE_VCTRL, MOD,
                            SREG, CTRL_ALPHA, CTRL_BETA, Instr, pad_program,
                            program_token)
from repro_torch.core.shard import mesh_signature
from repro_torch.core.vsr import (JPCG_MODULES, LOOP_CARRIED, Module, VSRSchedule,
                            schedule)

__all__ = ["CompileError", "CompiledProgram", "compile_schedule",
           "compile_policy", "canonical_program", "canonical_length",
           "executable_key", "PLAIN_CG_MODULES", "OPSPECS", "OpSpec"]

_N_QUEUES = 8


class CompileError(ValueError):
    """The schedule cannot be lowered to the stream ISA."""


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """ISA-level semantics of one module name.

    ``kind`` selects the VM's compute branch; ``sreg`` is the scalar
    register an axpy reads / a dot writes; ``operand_order`` permutes the
    module's declared ``reads`` into ISA (qa, qb) order — e.g. M5 is
    declared ``reads=("M", "r'")`` but divides r'/M.
    """

    kind: str                                  # spmv | dot | axpy | div
    sreg: Optional[str] = None
    neg: bool = False
    operand_order: Optional[Tuple[int, ...]] = None


#: ISA semantics per module name (shared by every module graph that reuses
#: the M1–M8 vocabulary — the VM's branch table is fixed, like the FPGA's).
OPSPECS: Dict[str, OpSpec] = {
    "M1_spmv":    OpSpec("spmv"),
    "M2_dot_pap": OpSpec("dot", "pap"),
    "M3_upd_x":   OpSpec("axpy", "alpha"),
    "M4_upd_r":   OpSpec("axpy", "alpha", neg=True),
    "M5_div_z":   OpSpec("div", operand_order=(1, 0)),   # z = r' / M
    "M6_dot_rz":  OpSpec("dot", "rz_new"),
    "M7_upd_p":   OpSpec("axpy", "beta"),
    "M8_dot_rr":  OpSpec("dot", "rr"),
}

#: scalars the controller derives from dot results (paper Type-II → CTRL).
_CTRL_OF_SCALAR = {"alpha": CTRL_ALPHA, "beta": CTRL_BETA}


#: Plain (non-preconditioned) CG on the same module vocabulary: M5 is gone
#: (z ≡ r'), M6 dots r'·r' for β, M7 updates p from r' directly.  With a
#: unit diagonal this iterates identically to JPCG.
PLAIN_CG_MODULES: Tuple[Module, ...] = (
    Module("M1_spmv",    reads=("p",),       writes=("ap",), heavy=True),
    Module("M2_dot_pap", reads=("p", "ap"),  writes=(), scalar_out="alpha"),
    Module("M3_upd_x",   reads=("x", "p"),   writes=("x'",),
           scalar_in=("alpha",)),
    Module("M4_upd_r",   reads=("r", "ap"),  writes=("r'",),
           scalar_in=("alpha",)),
    Module("M6_dot_rz",  reads=("r'",),      writes=(), scalar_out="beta"),
    Module("M7_upd_p",   reads=("r'", "p"),  writes=("p'",),
           scalar_in=("beta",)),
    Module("M8_dot_rr",  reads=("r'",),      writes=(), scalar_out="rr"),
)


def _buf(vec: str) -> int:
    """HBM buffer id of a vector name (primed names alias their buffer)."""
    base = LOOP_CARRIED.get(vec, vec)
    if base not in BUF:
        raise CompileError(
            f"vector {vec!r} has no HBM buffer (never-stored intermediates "
            "cannot be read from or written to memory)")
    return BUF[base]


def _operands(m: Module) -> Tuple[str, ...]:
    spec = OPSPECS[m.name]
    if spec.operand_order is not None:
        return tuple(m.reads[i] for i in spec.operand_order)
    return m.reads


# --------------------------------------------------------------- pass A
def _schedule_events(active: Sequence[str], writes: Sequence[str],
                     by_name: Dict[str, Module]) -> List[Tuple[str, str]]:
    """Order one phase's modules + HBM stores into an event list.

    Returns ``[("comp", module_name) | ("write", vec_name), ...]``.
    """
    mods = list(active)
    produced_by = {v: n for n in mods for v in by_name[n].writes}
    pending_writes = list(writes)
    has_consumer = {
        n: any(v in by_name[o].reads for o in mods if o != n
               for v in by_name[n].writes)
        for n in mods}

    emitted: List[Tuple[str, str]] = []
    done_mods: set = set()
    done_writes: Counter = Counter()
    live: set = set()          # values currently available in a queue
    read_shareable: set = set()

    def mod_ready(n: str) -> bool:
        return all(v not in produced_by or produced_by[v] in done_mods
                   for v in by_name[n].reads)

    def live_operands(n: str) -> int:
        return sum(1 for v in by_name[n].reads
                   if v in live or v in read_shareable)

    while len(done_mods) < len(mods) or sum(done_writes.values()) < len(
            pending_writes):
        ready_mods = [n for n in mods if n not in done_mods and mod_ready(n)]
        ready_writes = [v for v in pending_writes
                        if done_writes[v] < pending_writes.count(v)
                        and v in produced_by and produced_by[v] in done_mods]
        # 1. dot modules (scalar producers) — the M8 early-termination hoist
        dots = [n for n in ready_mods if OPSPECS[n].kind == "dot"]
        if dots:
            pick = dots[0]
        elif ready_writes:
            # 2. drain produced values to HBM as soon as they exist
            emitted.append(("write", ready_writes[0]))
            done_writes[ready_writes[0]] += 1
            continue
        elif ready_mods:
            # 3. prefer consuming live streams, then unblocking consumers
            pick = max(ready_mods,
                       key=lambda n: (live_operands(n), has_consumer[n],
                                      -mods.index(n)))
        else:
            raise CompileError(
                f"phase deadlock: modules {set(mods) - done_mods} never "
                "become ready (cyclic intra-phase dependency?)")
        emitted.append(("comp", pick))
        done_mods.add(pick)
        m = by_name[pick]
        for v in m.reads:
            if v not in produced_by and v not in read_shareable:
                if not m.heavy:
                    read_shareable.add(v)
        live.update(m.writes)
        continue
    return emitted


# --------------------------------------------------------------- pass B
def _emit_phase(events: List[Tuple[str, str]],
                by_name: Dict[str, Module]) -> Tuple[
                    List[Instr], List[str], List[str]]:
    """Assign queues and emit instructions for one phase's event list."""
    instrs: List[Instr] = []
    reads_emitted: List[str] = []
    writes_emitted: List[str] = []
    live: Dict[str, int] = {}        # value -> queue holding it
    shareable: Dict[str, bool] = {}  # read values: stream-shareable?
    remaining: Dict[int, int] = {}   # queue -> outstanding uses
    next_q = 0
    free: List[int] = []             # LIFO recycle stack

    def alloc() -> int:
        nonlocal next_q
        if next_q < _N_QUEUES:
            q = next_q
            next_q += 1
            return q
        if not free:
            raise CompileError("stream-queue pressure exceeds 8 FIFOs")
        return free.pop()

    def future_uses(start: int, vec: str, *, share: bool) -> int:
        """Queue uses of ``vec`` by events at index > start."""
        uses = 0
        for kind, name in events[start + 1:]:
            if kind == "comp" and share:
                uses += sum(1 for v in _operands(by_name[name]) if v == vec)
            elif kind == "write" and name == vec:
                uses += 1
        return uses

    def consume(q: int, vec: str) -> None:
        remaining[q] -= 1
        if remaining[q] == 0:
            free.append(q)
            del remaining[q]
            if live.get(vec) == q:
                del live[vec]

    for idx, (kind, name) in enumerate(events):
        if kind == "write":
            q = live.get(name)
            if q is None:
                raise CompileError(f"store of {name!r} before it exists")
            instrs.append(Instr(ITYPE_VCTRL, _buf(name), wr=1, qa=q))
            writes_emitted.append(name)
            consume(q, name)
            continue

        m = by_name[name]
        spec = OPSPECS[m.name]
        ops = _operands(m)
        qs: List[int] = []
        for v in ops:
            if v in live:
                qs.append(live[v])
                continue
            q = alloc()
            instrs.append(Instr(ITYPE_VCTRL, _buf(v), rd=1, qd=q))
            reads_emitted.append(v)
            live[v] = q
            share = not m.heavy          # §5.2 alignment constraint
            shareable[v] = share
            remaining[q] = 1 + (future_uses(idx, v, share=share)
                                if share else 0)
            qs.append(q)

        if spec.kind == "spmv":
            qd = alloc()
            out, = m.writes
            live[out] = qd
            remaining[qd] = future_uses(idx, out, share=True)
            instrs.append(Instr(ITYPE_COMP, MOD[m.name], qa=qs[0], qd=qd))
        elif spec.kind == "dot":
            qa = qs[0]
            qb = qs[1] if len(qs) > 1 else qs[0]
            instrs.append(Instr(ITYPE_COMP, MOD[m.name], qa=qa, qb=qb,
                                sreg=SREG[spec.sreg]))
        else:                            # axpy / div: dst = a (op s·) b
            qd = alloc()                 # claim output before inputs drain
            out, = m.writes
            live[out] = qd
            remaining[qd] = future_uses(idx, out, share=True)
            sreg = SREG[spec.sreg] if spec.sreg else 0
            instrs.append(Instr(ITYPE_COMP, MOD[m.name], rd=int(spec.neg),
                                qa=qs[0], qb=qs[1], qd=qd, sreg=sreg))
        for v, q in zip(ops, qs):
            if q in remaining:
                consume(q, v)
    return instrs, reads_emitted, writes_emitted


# ---------------------------------------------------------- entry points
@dataclasses.dataclass(frozen=True)
class CompiledProgram:
    """A lowered schedule: the int32[P, 8] word array + its provenance."""

    policy: str
    program: np.ndarray
    instrs: Tuple[Instr, ...]
    source: VSRSchedule

    @property
    def length(self) -> int:
        return int(self.program.shape[0])

    @property
    def cache_token(self) -> str:
        """Stable content hash of the (unpadded) program words.  The padded
        words are what runs, and :func:`~repro_torch.core.isa.program_token`
        of the padded array keys the runner and stepper caches; two
        programs with equal ``cache_token`` pad to equal bytes."""
        return program_token(self.program)

    def padded(self, length: int) -> np.ndarray:
        """NOP-pad to ``length`` (programs of one length share one VM)."""
        return pad_program(self.program, length)


def compile_schedule(sched: VSRSchedule,
                     modules: Sequence[Module] = JPCG_MODULES,
                     ) -> CompiledProgram:
    """Lower a VSR schedule to a stream-ISA program.

    Raises :class:`CompileError` if the emitted HBM traffic disagrees with
    the schedule's ``hbm_reads``/``hbm_writes`` plan — the compiler must
    implement exactly the traffic the analyzer promised.
    """
    by_name = {m.name: m for m in modules}
    missing = [n for p in sched.phases for n in p if n not in OPSPECS]
    if missing:
        raise CompileError(f"modules without ISA semantics: {missing}")

    instrs: List[Instr] = []
    for p, active in enumerate(sched.phases):
        events = _schedule_events(active, sched.hbm_writes[p], by_name)
        phase_instrs, reads, writes = _emit_phase(events, by_name)
        if Counter(reads) != Counter(sched.hbm_reads[p]):
            raise CompileError(
                f"phase {p}: emitted reads {sorted(reads)} != scheduled "
                f"{sorted(sched.hbm_reads[p])}")
        if Counter(writes) != Counter(sched.hbm_writes[p]):
            raise CompileError(
                f"phase {p}: emitted writes {sorted(writes)} != scheduled "
                f"{sorted(sched.hbm_writes[p])}")
        instrs.extend(phase_instrs)
        for name in (n for k, n in events if k == "comp"):
            s = by_name[name].scalar_out
            if s in _CTRL_OF_SCALAR:
                instrs.append(Instr(ITYPE_CTRL, _CTRL_OF_SCALAR[s]))

    enc = np.asarray([i.encode() for i in instrs], dtype=np.int32)
    return CompiledProgram(policy=sched.policy, program=enc,
                           instrs=tuple(instrs), source=sched)


@lru_cache(maxsize=None)
def compile_policy(policy: str = "paper",
                   modules: Tuple[Module, ...] = JPCG_MODULES,
                   ) -> CompiledProgram:
    """Compile ``vsr.schedule(modules, policy)`` (memoized — programs are
    pure functions of (policy, module graph))."""
    return compile_schedule(schedule(modules, policy=policy), modules)


@lru_cache(maxsize=None)
def canonical_length(modules: Tuple[Module, ...] = JPCG_MODULES) -> int:
    """Shared padded program length across this graph's policies — every
    policy's program NOP-pads to this, so one compiled VM runs them all."""
    return max(compile_policy(p, modules).length
               for p in ("paper", "min_traffic"))


def canonical_program(policy: str = "paper",
                      modules: Tuple[Module, ...] = JPCG_MODULES,
                      ) -> np.ndarray:
    """Compile ``policy`` and pad to the graph's canonical shared length."""
    return compile_policy(policy, modules).padded(canonical_length(modules))


def executable_key(kind: str, *, backend: str, scheme: str, bucket,
                   steps_per_sync: int, donate: bool,
                   layout: Optional[str] = None,
                   index_bytes: Optional[int] = None,
                   batch: Optional[int] = None,
                   maxiter: Optional[int] = None,
                   chunk: Optional[int] = None,
                   with_trace: Optional[bool] = None,
                   detect: Optional[bool] = None,
                   program: Optional[np.ndarray] = None,
                   mesh=None, block_rows: Optional[int] = None) -> tuple:
    """Canonical cache key for VM/phases runners and steppers.

    One function builds every key so the fields that split runners are
    impossible to forget at any call site: ``kind`` (runner vs stepper),
    ``backend``/``scheme``, ``bucket`` (padded operand dims: row-ELL
    ``(n_pad, W)``, sliced-ELL ``(n_pad, rows0, w0, rows1, w1, ...)``,
    ELLPACK ``(B, T, E, n_tiles)``), ``layout``, ``index_bytes``,
    ``batch``/``maxiter``/``with_trace`` (solve runners), ``chunk``
    (steppers), ``steps_per_sync``, ``donate``, ``detect``, ``mesh`` (a
    lane mesh or its :func:`~repro_torch.core.shard.mesh_signature`: a
    sharded runner never shares a key with the unsharded one or with
    another mesh size) and — for specialized runners only — the program's
    :func:`~repro_torch.core.isa.program_token`.  A ``block_rows`` the
    caller asked to be checked against its operand splits the key too.
    """
    key = (kind, backend, scheme, batch, tuple(np.ravel(bucket).tolist()),
           layout, index_bytes, maxiter, chunk, with_trace,
           int(steps_per_sync), bool(donate),
           None if detect is None else bool(detect), mesh_signature(mesh))
    if block_rows is not None:
        key += (("block_rows", int(block_rows)),)
    if program is not None:
        key += (program_token(np.asarray(program, np.int32)),)
    return key
