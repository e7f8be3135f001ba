"""Core of the torch port: precision schemes, the VSR schedule and the
stream-ISA compiler (numpy copies), the health layer, the single-system
solver (:func:`jpcg_solve`, with its phases, pipelined loop and
operators), the batched phases engine and the specialized stream VM.
Exports the reference's :mod:`repro.core` names."""
from repro_torch.core.cg import CGResult, jpcg_solve
from repro_torch.core.batch import jpcg_solve_batched
from repro_torch.core.compile import compile_policy, compile_schedule
from repro_torch.core.precision import SCHEMES, PrecisionScheme, get_scheme
from repro_torch.core.vsr import access_counts, schedule

__all__ = ["CGResult", "jpcg_solve", "jpcg_solve_batched", "SCHEMES",
           "PrecisionScheme", "get_scheme", "access_counts", "schedule",
           "compile_policy", "compile_schedule"]
