"""Solver result type (the ``CGResult`` of :mod:`repro.core.cg`).

The single-system ``jpcg_solve`` is not ported yet; the batched solver
(:func:`repro_torch.core.batch.jpcg_solve_batched`) and the serving
engine return one :class:`CGResult` per lane.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["CGResult"]


@dataclasses.dataclass
class CGResult:
    x: torch.Tensor
    iterations: int
    rr: float               # final ‖r‖²
    converged: bool
    residual_trace: Optional[np.ndarray]   # rr per iteration, if requested
    scheme: str
    method: str
    # Exit status name (repro_torch.core.metrics.STATUS_NAMES): "CONVERGED"
    # / "MAXITER" / "BREAKDOWN_INDEFINITE" / "BREAKDOWN_NONFINITE"; None
    # with with_status=False.
    status: Optional[str] = None
    # True when the serving engine's escalation policy re-ran this
    # request at fp64 after a mixed-precision breakdown.
    retried: bool = False

    def __repr__(self) -> str:  # keep tensor printing out of logs
        extra = f", status={self.status}" if self.status else ""
        extra += ", retried" if self.retried else ""
        return (f"CGResult(iters={self.iterations}, rr={self.rr:.3e}, "
                f"converged={self.converged}, scheme={self.scheme}, "
                f"method={self.method}{extra})")
