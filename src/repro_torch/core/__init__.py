"""Core of the torch port: precision schemes, the stream-ISA compiler
(numpy copies), the health layer, the single-system solver
(:func:`jpcg_solve`, with its phases, pipelined loop and operators), the
batched phases engine and the specialized stream VM.  The batched entry
point is imported from its submodule:
``from repro_torch.core.batch import jpcg_solve_batched``."""
from repro_torch.core.cg import CGResult, jpcg_solve

__all__ = ["CGResult", "jpcg_solve"]
