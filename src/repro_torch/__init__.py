"""PyTorch/CUDA port of the batched Callipepla JPCG solver stack.

The JAX package :mod:`repro` is the reference; this package mirrors its
module names so each counterpart is easy to find:

* :mod:`repro_torch.core.batch` — ``jpcg_solve_batched`` (``engine="vm"``
  | ``"phases"``), the batched SpMV dispatch and the masked loop;
* :mod:`repro_torch.core.vm` — the specialized batched stream VM;
* :mod:`repro_torch.serve.solver_engine` — the continuous-batching
  ``SolverEngine``;
* :mod:`repro_torch.kernels.spmv` — the hand-written Hopper SpMV kernels
  (CUDA C++ under ``kernels/csrc``) beside their plain PyTorch versions;
* :mod:`repro_torch.sparse` / :mod:`repro_torch.core.compile` — host-side
  packing and the stream-ISA compiler, kept as numpy copies so the port
  imports nothing from :mod:`repro`.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).
"""
