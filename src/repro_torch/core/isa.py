"""Stream-centric instruction set (paper §4) — encodings, the golden
hand assembly and the disassembler (a copy of :mod:`repro.core.isa`).

A program is one ``int32[P, 8]`` array of words:

  =====  =============================================================
  field  meaning
  =====  =============================================================
  0      itype: 0=VCTRL (Type-I), 1=COMP (Type-II), 2=CTRL (scalar op),
         3=NOP
  1      VCTRL: memory buffer id · COMP: module id (0..7 = M1..M8) ·
         CTRL: 0 -> α = rz/pap, 1 -> β = rz_new/rz ; rz ← rz_new
  2      VCTRL: rd flag · COMP: sign flag for the axpy scalar (0:+, 1:−)
  3      VCTRL: wr flag
  4      src queue a
  5      src queue b
  6      dst queue (VCTRL rd / COMP vector output)
  7      scalar register index (COMP: axpy reads it, dots write it)
  =====  =============================================================

Type-III memory instructions are *derived*: a VCTRL word with rd/wr set
makes its vector-control module issue the matching read or write to the
memory engine; :func:`derived_mem_instructions` counts them (10 reads +
4 writes for the paper schedule, the §5.5 accounting).

Memory buffers: 0=x, 1=r, 2=p, 3=ap, 4=M (diagonal), 5=b.
Scalar registers: 0=α, 1=β, 2=rz, 3=rr, 4=pap, 5=rz_new.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = [
    "ITYPE_VCTRL", "ITYPE_COMP", "ITYPE_CTRL", "ITYPE_NOP",
    "MOD", "BUF", "SREG", "CTRL_ALPHA", "CTRL_BETA", "Instr",
    "assemble_jpcg", "derived_mem_instructions", "decode_program",
    "program_text", "pad_program", "program_token",
]

ITYPE_VCTRL, ITYPE_COMP, ITYPE_CTRL, ITYPE_NOP = 0, 1, 2, 3

#: computation modules, paper Fig. 1 (index = module id)
MOD = {"M1_spmv": 0, "M2_dot_pap": 1, "M3_upd_x": 2, "M4_upd_r": 3,
       "M5_div_z": 4, "M6_dot_rz": 5, "M7_upd_p": 6, "M8_dot_rr": 7}

BUF = {"x": 0, "r": 1, "p": 2, "ap": 3, "M": 4, "b": 5}
SREG = {"alpha": 0, "beta": 1, "rz": 2, "rr": 3, "pap": 4, "rz_new": 5}

CTRL_ALPHA, CTRL_BETA = 0, 1


@dataclasses.dataclass(frozen=True)
class Instr:
    itype: int
    f1: int = 0
    rd: int = 0
    wr: int = 0
    qa: int = 0
    qb: int = 0
    qd: int = 0
    sreg: int = 0

    def encode(self) -> List[int]:
        return [self.itype, self.f1, self.rd, self.wr,
                self.qa, self.qb, self.qd, self.sreg]


def _rd(buf: str, qd: int) -> Instr:
    return Instr(ITYPE_VCTRL, BUF[buf], rd=1, qd=qd)


def _wr(buf: str, qs: int) -> Instr:
    return Instr(ITYPE_VCTRL, BUF[buf], wr=1, qa=qs)


def _comp(mod: str, qa: int, qb: int = 0, qd: int = 0, sreg: str = "alpha",
          neg: bool = False) -> Instr:
    return Instr(ITYPE_COMP, MOD[mod], rd=int(neg), qa=qa, qb=qb, qd=qd,
                 sreg=SREG[sreg])


def _ctrl(which: int) -> Instr:
    return Instr(ITYPE_CTRL, which)


def assemble_jpcg(policy: str = "paper") -> Tuple[np.ndarray, List[Instr]]:
    """Emit one JPCG iteration under the VSR schedule — *golden reference*.

    Returns (encoded int32[P, 8] program, decoded instruction list).
    The two policies differ exactly as :mod:`repro_torch.core.vsr` computes:
    ``paper`` re-runs M4+M5 in phase 3 (r' stored by the re-run pass-
    through), ``min_traffic`` stores r' straight out of phase 2.

    Production programs come from the schedule→program compiler
    (:func:`repro_torch.core.compile.compile_policy`), which reproduces
    this hand assembly word for word for the paper policy.  This function
    stays as the human-audited transcription of the paper's Fig. 2 / §5.5
    controller sequence.
    """
    P: List[Instr] = []
    # ------- Phase 1: M1 (SpMV), M2 (dot) --------------------------------
    P += [_rd("p", qd=0),                                   # p -> M1
          _comp("M1_spmv", qa=0, qd=1),                     # ap stream
          _rd("p", qd=2),                                   # p -> M2 (2nd read:
          _comp("M2_dot_pap", qa=2, qb=1, sreg="pap"),      #  gather-order mismatch)
          _wr("ap", qs=1),                                  # ap store
          _ctrl(CTRL_ALPHA)]                                # α = rz/pap
    # ------- Phase 2: M4, M8, M5, M6 --------------------------------------
    P += [_rd("r", qd=0),
          _rd("ap", qd=1),
          _comp("M4_upd_r", qa=0, qb=1, qd=2, sreg="alpha", neg=True),  # r'
          _comp("M8_dot_rr", qa=2, qb=2, sreg="rr")]        # hoisted: early exit
    if policy == "min_traffic":
        P += [_wr("r", qs=2)]                               # store r' now (13-access)
    P += [_rd("M", qd=3),
          _comp("M5_div_z", qa=2, qb=3, qd=4),              # z (never stored)
          _comp("M6_dot_rz", qa=2, qb=4, sreg="rz_new"),
          _ctrl(CTRL_BETA)]                                 # β = rz'/rz ; rz ← rz'
    # ------- Phase 3: (recompute M4, M5), M7, M3 ---------------------------
    if policy == "paper":
        P += [_rd("r", qd=0),
              _rd("ap", qd=1),
              _comp("M4_upd_r", qa=0, qb=1, qd=2, sreg="alpha", neg=True),
              _wr("r", qs=2),                               # r' store of record
              _rd("M", qd=3),
              _comp("M5_div_z", qa=2, qb=3, qd=4)]          # z recomputed
    else:
        P += [_rd("r", qd=2),                               # r' from HBM
              _rd("M", qd=3),
              _comp("M5_div_z", qa=2, qb=3, qd=4)]          # z recomputed (light)
    P += [_rd("p", qd=5),
          _comp("M7_upd_p", qa=4, qb=5, qd=6, sreg="beta"),  # p' = z + β·p
          _wr("p", qs=6),
          _rd("x", qd=7),
          _comp("M3_upd_x", qa=7, qb=5, qd=6, sreg="alpha"),  # x' = x + α·p
          _wr("x", qs=6)]                                   # (p stream reused ✓)
    enc = np.asarray([i.encode() for i in P], dtype=np.int32)
    return enc, P


def derived_mem_instructions(program: np.ndarray) -> dict:
    """Type-III InstRdWr stream a program's VCTRL instructions generate."""
    vctrl = program[program[:, 0] == ITYPE_VCTRL]
    reads = int(vctrl[:, 2].sum())
    writes = int(vctrl[:, 3].sum())
    return {"reads": reads, "writes": writes, "total": reads + writes}


def decode_program(program: np.ndarray) -> List[Instr]:
    """Decode an int32[P, 8] word array back to :class:`Instr` records."""
    return [Instr(*(int(v) for v in w)) for w in np.asarray(program)]


def program_text(program: np.ndarray) -> str:
    """Human-readable disassembly (one line per word) — for test diffs
    and ARCHITECTURE.md walkthroughs, not for execution."""
    buf_of = {v: k for k, v in BUF.items()}
    mod_of = {v: k for k, v in MOD.items()}
    sreg_of = {v: k for k, v in SREG.items()}
    lines = []
    for pc, i in enumerate(decode_program(program)):
        if i.itype == ITYPE_VCTRL:
            op = (f"rd   {buf_of[i.f1]:2s} -> q{i.qd}" if i.rd
                  else f"wr   {buf_of[i.f1]:2s} <- q{i.qa}")
        elif i.itype == ITYPE_COMP:
            mod = mod_of[i.f1]
            if mod in ("M2_dot_pap", "M6_dot_rz", "M8_dot_rr"):
                op = f"{mod}: s[{sreg_of[i.sreg]}] = q{i.qa}.q{i.qb}"
            elif mod == "M1_spmv":
                op = f"{mod}: q{i.qd} = A @ q{i.qa}"
            elif mod == "M5_div_z":
                op = f"{mod}: q{i.qd} = q{i.qa} / q{i.qb}"
            else:
                sign = "-" if i.rd else "+"
                op = (f"{mod}: q{i.qd} = q{i.qa} {sign} "
                      f"s[{sreg_of[i.sreg]}]*q{i.qb}")
        elif i.itype == ITYPE_CTRL:
            op = ("ctrl alpha = rz/pap" if i.f1 == CTRL_ALPHA
                  else "ctrl beta = rz'/rz ; rz <- rz'")
        else:
            op = "nop"
        lines.append(f"{pc:3d}  {op}")
    return "\n".join(lines)


def program_token(program: np.ndarray) -> str:
    """Stable content hash of an ``int32[P, 8]`` program word array.

    Two programs share a token iff they are word-identical (NOP padding
    included — the padded words are the bytes that run).  It is the
    cache-key component of the specialized VM runners and steppers
    (:func:`repro_torch.core.vm.make_vm_runner` with ``program=``).
    """
    import hashlib
    words = np.ascontiguousarray(np.asarray(program, dtype=np.int32))
    return hashlib.sha1(words.tobytes()).hexdigest()[:16]


def pad_program(program: np.ndarray, length: int) -> np.ndarray:
    """NOP-pad so differently-scheduled programs share one length."""
    if program.shape[0] > length:
        raise ValueError(f"program length {program.shape[0]} > pad {length}")
    pad = np.zeros((length - program.shape[0], 8), dtype=np.int32)
    pad[:, 0] = ITYPE_NOP
    return np.concatenate([program, pad], axis=0)
