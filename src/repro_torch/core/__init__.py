"""Core of the torch port: precision schemes, the stream-ISA compiler
(numpy copies), the health layer, the batched phases engine and the
specialized stream VM.  Import the submodules directly, e.g.
``from repro_torch.core.batch import jpcg_solve_batched``."""
