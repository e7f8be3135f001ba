"""Serving layer of the torch port: the continuous-batching
:class:`~repro_torch.serve.solver_engine.SolverEngine`."""
from repro_torch.serve.solver_engine import SolverEngine, SolverEngineConfig

__all__ = ["SolverEngine", "SolverEngineConfig"]
