"""Stream-centric instruction set (paper §4) — encodings (a copy of the
part of :mod:`repro.core.isa` the compiler and the VM use).

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

Memory buffers: 0=x, 1=r, 2=p, 3=ap, 4=M (diagonal), 5=b.
Scalar registers: 0=α, 1=β, 2=rz, 3=rr, 4=pap, 5=rz_new.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = [
    "ITYPE_VCTRL", "ITYPE_COMP", "ITYPE_CTRL", "ITYPE_NOP",
    "MOD", "BUF", "SREG", "CTRL_ALPHA", "CTRL_BETA", "Instr",
    "pad_program", "program_token",
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
