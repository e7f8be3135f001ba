"""PyTorch/CUDA port of the Callipepla JPCG solver stack.

The JAX package :mod:`repro` is the reference; this package mirrors its
module names so each counterpart is easy to find:

* :mod:`repro_torch.core.cg` — ``jpcg_solve``, the single-system solver
  (``method="vsr"`` | ``"pipelined"``, ``backend="xla"`` | ``"pallas"``);
* :mod:`repro_torch.core.batch` — ``jpcg_solve_batched`` (``engine="vm"``
  | ``"phases"``), the batched SpMV dispatch and the masked loop;
* :mod:`repro_torch.core.vm` — the specialized batched stream VM;
* :mod:`repro_torch.serve.solver_engine` — the continuous-batching
  ``SolverEngine``;
* :mod:`repro_torch.kernels` — the hand-written Hopper kernels (CUDA C++
  under ``kernels/csrc``: SpMV, dot/dot3, fused phases 2 and 3) beside
  their plain PyTorch versions;
* :mod:`repro_torch.sparse` / :mod:`repro_torch.core.compile` — host-side
  packing and the stream-ISA compiler, kept as numpy copies so the port
  imports nothing from :mod:`repro`.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).
"""
from repro_torch.core.cg import CGResult, jpcg_solve

__all__ = ["CGResult", "jpcg_solve"]
