"""Public single-system JPCG solver API (the port of :mod:`repro.core.cg`).

>>> from repro_torch.core.cg import jpcg_solve
>>> res = jpcg_solve(A, scheme="mixed_v3", tol=1e-12, maxiter=20_000)
>>> res.x, res.iterations, res.converged

Matches the paper's evaluation protocol (§7.1): b defaults to all-ones,
x0 to all-zeros, stop criterion ‖r‖² < 1e-12, 20 K max iterations.

``A`` may be a :class:`~repro_torch.sparse.csr.CSRMatrix`, a
:class:`~repro_torch.sparse.bell.BellMatrix` (``backend="xla"``) or
:class:`~repro_torch.sparse.ellpack.EllpackMatrix` (``backend="pallas"``)
with an explicit ``diag``, an operator, a dense array, or a matrix-free
callable (with explicit ``diag``/``n``).

``method``:
  * ``"vsr"``       — the paper-faithful three-phase loop (default);
  * ``"pipelined"`` — the single-reduction variant
    (:mod:`repro_torch.core.pipelined`).

``backend`` (the reference's names):
  * ``"xla"``    — plain PyTorch phase ops and banked-ELL SpMV (default);
  * ``"pallas"`` — the hand-written kernels: the ELLPACK SpMV, and with
    ``method="vsr"`` the dot and fused phase-2/phase-3 kernels, on every
    iteration (:mod:`repro_torch.kernels.ops`).  On CPU tensors each
    kernel's plain PyTorch version runs instead.

``device`` defaults to ``"cuda"`` (:func:`repro_torch.device.
resolve_device`).  The batched solver
(:func:`repro_torch.core.batch.jpcg_solve_batched`) and the serving
engine return one :class:`CGResult` per lane.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import phases as _phases
from repro_torch.core import pipelined as _pipe
from repro_torch.core.operators import as_operator
from repro_torch.core.precision import get_scheme
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels.ops import bell_operator_pallas, make_phase_ops

__all__ = ["CGResult", "jpcg_solve"]


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
    # from jpcg_solve (as in the reference) or with with_status=False.
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


def _run_vsr(op, diag, b, x0, *, tol, maxiter, scheme, with_trace,
             backend="xla"):
    st = _phases.init_state(op.matvec, diag, b, x0, maxiter=maxiter,
                            scheme=scheme, with_trace=with_trace)
    phase_ops = make_phase_ops() if backend == "pallas" else None
    return _phases.jpcg_loop(op.matvec, diag, st, tol=tol, maxiter=maxiter,
                             scheme=scheme, phase_ops=phase_ops)


def _run_pipe(op, diag, b, x0, *, tol, maxiter, scheme, with_trace,
              replace_every):
    st = _pipe.pipecg_init(op.matvec, diag, b, x0, maxiter=maxiter,
                           scheme=scheme, with_trace=with_trace)
    return _pipe.pipecg_loop(op.matvec, diag, b, st, tol=tol, maxiter=maxiter,
                             scheme=scheme, replace_every=replace_every)


def _vector(v, n: int, fill: float, dtype, device) -> torch.Tensor:
    if v is None:
        return torch.full((n,), fill, dtype=dtype, device=device)
    return to_device(v, device, dtype)


def jpcg_solve(a, b=None, x0=None, *, tol: float = 1e-12,
               maxiter: int = 20_000, scheme="mixed_v3", method: str = "vsr",
               backend: str = "xla", diag=None, n: Optional[int] = None,
               with_trace: bool = False,
               replace_every: int = _pipe.REPLACE_EVERY,
               block_rows: int = 256, col_tile: int = 512,
               device=None) -> CGResult:
    scheme = get_scheme(scheme)
    dev = resolve_device(device)
    if backend == "pallas":
        op = bell_operator_pallas(a, scheme, diag=diag,
                                  block_rows=block_rows, col_tile=col_tile,
                                  device=dev)
    elif backend == "xla":
        op = as_operator(a, scheme, diag=diag, n=n, block_rows=block_rows,
                         col_tile=col_tile, device=dev)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    if op.device != dev:
        raise ValueError(f"the operator lives on {op.device}, the solve on "
                         f"{dev}")

    vd = scheme.vector_dtype
    b = _vector(b, op.n, 1.0, vd, dev)
    x0 = _vector(x0, op.n, 0.0, vd, dev)
    d = op.diag.to(vd)

    if method == "vsr":
        st = _run_vsr(op, d, b, x0, tol=tol, maxiter=maxiter,
                      scheme=scheme, with_trace=with_trace, backend=backend)
    elif method == "pipelined":
        st = _run_pipe(op, d, b, x0, tol=tol, maxiter=maxiter,
                       scheme=scheme, with_trace=with_trace,
                       replace_every=replace_every)
    else:
        raise ValueError(f"unknown method {method!r}")

    iters = int(st.i)
    rr = float(st.rr)
    trace = None
    if with_trace:
        trace = st.trace[:iters].cpu().numpy()
    return CGResult(x=st.x, iterations=iters, rr=rr,
                    converged=bool(rr <= tol), residual_trace=trace,
                    scheme=scheme.name, method=method)
