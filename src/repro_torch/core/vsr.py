"""Vector streaming reuse (VSR) analysis — paper §5 (a copy of
:mod:`repro.core.vsr`, which the compiler lowers to stream-ISA programs).

The JPCG loop body is partitioned into phases by *scalar dependency*: a
dot product consumes a whole vector before its scalar exists, so any
module needing that scalar starts a new phase; within a phase, vectors
flow module to module and touch device memory at most once each.
:func:`schedule` computes, from the dataflow graph ``JPCG_MODULES``:

1. earliest phase per module from the scalar-barrier closure,
2. a *sink* pass moving modules without intra-iteration consumers to
   their latest legal phase (M3 lands in phase 3, sharing ``p`` with M7),
3. store-vs-recompute decisions for intermediates (``z`` never stored),
4. the per-phase read/write/stream plan, honoring the alignment
   constraint that the SpMV's gather-ordered read of ``p`` cannot be
   shared with row-ordered consumers.

``policy="paper"`` re-runs M4→M5 in phase 3 (14 accesses = 10 reads +
4 writes); ``policy="min_traffic"`` stores ``r'`` out of phase 2
(13 = 9 + 4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

__all__ = ["Module", "JPCG_MODULES", "LOOP_CARRIED", "schedule",
           "access_counts", "VSRSchedule"]

#: loop-carried vectors: produced as v', consumed next iteration as v.
LOOP_CARRIED = {"r'": "r", "p'": "p", "x'": "x"}


@dataclasses.dataclass(frozen=True)
class Module:
    """One processing module (paper's M1–M8)."""

    name: str
    reads: Tuple[str, ...]            # vector inputs
    writes: Tuple[str, ...]           # vector outputs (() for dot modules)
    scalar_out: str | None = None     # scalar produced (dot modules)
    scalar_in: Tuple[str, ...] = ()   # scalars required
    heavy: bool = False               # streams the matrix operand (SpMV):
                                      # gather-ordered reads, not re-runnable


# Algorithm 1 loop body.  Unprimed names are previous-iteration values.
JPCG_MODULES: Tuple[Module, ...] = (
    Module("M1_spmv",    reads=("p",),        writes=("ap",), heavy=True),
    Module("M2_dot_pap", reads=("p", "ap"),   writes=(), scalar_out="alpha"),
    Module("M3_upd_x",   reads=("x", "p"),    writes=("x'",), scalar_in=("alpha",)),
    Module("M4_upd_r",   reads=("r", "ap"),   writes=("r'",), scalar_in=("alpha",)),
    Module("M5_div_z",   reads=("M", "r'"),   writes=("z",)),
    Module("M6_dot_rz",  reads=("r'", "z"),   writes=(), scalar_out="beta"),
    Module("M7_upd_p",   reads=("z", "p"),    writes=("p'",), scalar_in=("beta",)),
    Module("M8_dot_rr",  reads=("r'",),       writes=(), scalar_out="rr"),
)


@dataclasses.dataclass(frozen=True)
class VSRSchedule:
    policy: str
    phases: Tuple[Tuple[str, ...], ...]      # module names per phase (incl. re-runs)
    hbm_reads: Tuple[Tuple[str, ...], ...]   # vectors read from HBM per phase
    hbm_writes: Tuple[Tuple[str, ...], ...]  # vectors written to HBM per phase
    streamed: Tuple[Tuple[str, ...], ...]    # vectors handed off on-chip per phase
    recomputed: Tuple[str, ...]              # modules re-executed in a later phase
    never_stored: Tuple[str, ...]            # vectors that never touch HBM

    @property
    def n_reads(self) -> int:
        return sum(len(r) for r in self.hbm_reads)

    @property
    def n_writes(self) -> int:
        return sum(len(w) for w in self.hbm_writes)

    @property
    def n_accesses(self) -> int:
        return self.n_reads + self.n_writes


def _earliest_levels(modules: Sequence[Module]) -> Dict[str, int]:
    """Earliest phase per module: scalar deps are barriers (+1), vector deps
    keep producers no later than consumers (same phase allowed: streaming)."""
    scalar_prod = {m.scalar_out: m.name for m in modules if m.scalar_out}
    vec_prod = {v: m.name for m in modules for v in m.writes}
    by_name = {m.name: m for m in modules}
    level: Dict[str, int] = {}

    def lvl(name: str) -> int:
        if name in level:
            return level[name]
        m = by_name[name]
        dep = 0
        for s in m.scalar_in:
            dep = max(dep, lvl(scalar_prod[s]) + 1)
        for v in m.reads:
            if v in vec_prod:
                dep = max(dep, lvl(vec_prod[v]))
        level[name] = dep
        return dep

    for m in modules:
        lvl(m.name)
    return level


def _topo_order(names: List[str], by_name: Dict[str, Module]) -> List[str]:
    """Order modules within a phase so producers precede consumers."""
    produced = {v: n for n in names for v in by_name[n].writes}
    out: List[str] = []
    visiting: set = set()

    def visit(n: str):
        if n in out or n in visiting:
            return
        visiting.add(n)
        for v in by_name[n].reads:
            if v in produced and produced[v] != n:
                visit(produced[v])
        visiting.discard(n)
        out.append(n)

    for n in names:
        visit(n)
    return out


def schedule(modules: Sequence[Module] = JPCG_MODULES,
             policy: str = "paper") -> VSRSchedule:
    """Compute the VSR schedule under ``policy`` ("paper" | "min_traffic")."""
    if policy not in ("paper", "min_traffic"):
        raise ValueError(f"unknown policy {policy!r}")
    by_name = {m.name: m for m in modules}
    vec_prod = {v: m.name for m in modules for v in m.writes}
    level = _earliest_levels(modules)
    n_phases = max(level.values()) + 1

    # --- sink pass: a module that writes only loop-carried vectors (no
    # intra-iteration consumer, no scalar output) may run in any phase >=
    # its earliest; run it in the last phase, where stream-sharing
    # opportunities are maximal (reproduces the paper's M3 -> phase 3).
    # Dot modules are never sunk: their scalars gate later phases, and the
    # paper deliberately hoists M8 (rr) early for on-the-fly termination.
    placement = dict(level)
    for m in modules:
        if not m.writes or m.scalar_out is not None:
            continue
        consumers = [level[o.name] for o in modules
                     for v in m.writes if v in o.reads]
        latest = min(consumers) if consumers else n_phases - 1
        if latest > placement[m.name]:
            placement[m.name] = latest

    base_phases: List[List[str]] = [
        [m.name for m in modules if placement[m.name] == p] for p in range(n_phases)]

    consumed_in: Dict[str, List[int]] = {}
    for m in modules:
        for v in m.reads:
            consumed_in.setdefault(v, []).append(placement[m.name])

    # --- store vs recompute ------------------------------------------------
    # Intermediates (not loop-carried) consumed in a later phase: recompute
    # if the producer chain is light (no SpMV), else store.
    stored_at: Dict[str, int] = {}          # vector -> phase of its HBM write
    never_stored: List[str] = []
    rerun_into: Dict[int, List[str]] = {}   # phase -> re-executed module chain

    def light_chain(name: str, target_phase: int) -> List[str] | None:
        """Modules to re-run in target_phase, reading only HBM-stored vectors."""
        m = by_name[name]
        if m.heavy:
            return None
        chain: List[str] = []
        for v in m.reads:
            if v in vec_prod:
                producer = vec_prod[v]
                if v in stored_at and stored_at[v] < target_phase:
                    continue                  # already in HBM by then
                sub = light_chain(producer, target_phase)
                if sub is None:
                    return None
                chain.extend(sub)
        chain.append(name)
        return list(dict.fromkeys(chain))

    # Loop-carried vectors must reach HBM.  Under the paper policy r' may
    # only be written by M5's phase-3 pass-through (FSM port constraint).
    for v in LOOP_CARRIED:
        p = placement[vec_prod[v]]
        if policy == "paper" and v == "r'":
            stored_at[v] = n_phases - 1
        else:
            stored_at[v] = p

    for v, prod in vec_prod.items():
        p = placement[prod]
        later = sorted({q for q in consumed_in.get(v, []) if q > p})
        if v in LOOP_CARRIED:
            continue
        if not later:
            if any(q == p for q in consumed_in.get(v, [])) and len(
                    consumed_in.get(v, [])) >= 0:
                pass
            continue
        chain = light_chain(prod, later[0])
        if chain is not None:
            never_stored.append(v)
            for q in later:
                ch = light_chain(prod, q) or []
                rerun_into.setdefault(q, []).extend(ch)
        else:
            stored_at[v] = p   # e.g. ap: SpMV output, must be stored

    # Under the paper policy the phase-3 rerun of M4 regenerates r' and is
    # the store of record for it; record that rerun explicitly.
    if policy == "paper":
        rp = stored_at["r'"]
        if vec_prod["r'"] not in rerun_into.get(rp, []) and placement[
                vec_prod["r'"]] != rp:
            chain = ["M4_upd_r"] if "M4_upd_r" in by_name else []
            rerun_into.setdefault(rp, [])
            # r' producer must come before its consumers in that phase
            rerun_into[rp] = chain + rerun_into[rp]

    recomputed = sorted({n for ch in rerun_into.values() for n in ch})

    # --- per-phase HBM plan --------------------------------------------------
    phases, hbm_reads, hbm_writes, streamed = [], [], [], []
    for p in range(n_phases):
        active = _topo_order(
            list(dict.fromkeys(base_phases[p] + rerun_into.get(p, []))), by_name)
        reads: List[str] = []
        writes: List[str] = []
        streams: List[str] = []
        produced_here: set = set()
        # alignment constraint: gather-order reads (heavy modules) can't share
        shareable_reads: set = set()
        for name in active:
            m = by_name[name]
            for v in m.reads:
                if v in produced_here:
                    if v not in streams:
                        streams.append(v)        # on-chip producer hand-off
                elif v in shareable_reads:
                    streams.append(v)            # second consumer, one read
                else:
                    reads.append(v)
                    if not m.heavy:
                        shareable_reads.add(v)
            produced_here.update(m.writes)
        for name in active:
            for v in by_name[name].writes:
                if v in never_stored:
                    continue
                if stored_at.get(v) == p and v not in writes:
                    writes.append(v)
        phases.append(tuple(active))
        # NOTE: reads may legitimately repeat (phase 1 reads `p` twice: the
        # SpMV's gather-ordered pass cannot be shared with M2's row-ordered
        # pass) — duplicates are distinct HBM accesses and must be counted.
        hbm_reads.append(tuple(reads))
        hbm_writes.append(tuple(dict.fromkeys(writes)))
        streamed.append(tuple(dict.fromkeys(streams)))

    return VSRSchedule(policy=policy, phases=tuple(phases),
                       hbm_reads=tuple(hbm_reads), hbm_writes=tuple(hbm_writes),
                       streamed=tuple(streamed), recomputed=tuple(recomputed),
                       never_stored=tuple(dict.fromkeys(never_stored)))


def access_counts(modules: Sequence[Module] = JPCG_MODULES
                  ) -> Dict[str, Dict[str, int]]:
    """Paper §5.5 accounting: naive 19 (14R+5W), paper-VSR 14 (10R+4W),
    and the min-traffic schedule 13 (9R+4W)."""
    naive_reads = sum(len(m.reads) for m in modules)
    naive_writes = sum(len(m.writes) for m in modules)
    out = {"naive": {"reads": naive_reads, "writes": naive_writes,
                     "total": naive_reads + naive_writes}}
    for pol in ("paper", "min_traffic"):
        s = schedule(modules, policy=pol)
        out[pol] = {"reads": s.n_reads, "writes": s.n_writes,
                    "total": s.n_accesses}
    return out
