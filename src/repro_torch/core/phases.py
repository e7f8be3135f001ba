"""Phase-structured JPCG loop (the torch port of :mod:`repro.core.phases`).

* **Phase 1**: M1 SpMV (``ap = A·p``) then M2 dot (``pap = p·ap``) —
  barrier: ``alpha = rz / pap``.
* **Phase 2**: ``r' = r − α·ap`` (M4), ``rr = r'·r'`` (M8, hoisted for
  early termination), ``z = M⁻¹·r'`` (M5), ``rz' = r'·z`` (M6) —
  barrier: ``beta = rz'/rz``.
* **Phase 3**: ``p' = z + β·p`` (M7), ``x' = x + α·p`` (M3).

The batched phases engine (:mod:`repro_torch.core.batch`) runs
:func:`vsr_iteration` on ``[G, n]`` lanes with a row-wise dot; it is the
oracle the stream VM (:mod:`repro_torch.core.vm`) is held to bitwise.
Every product and sum is its own eager op, so no step fuses into a
contracted multiply-add and the VM's word-by-word spelling of the same
arithmetic lands on the same bits.

The single-system loop :func:`jpcg_loop` runs the same iteration, or,
given ``phase_ops`` (:func:`repro_torch.kernels.ops.make_phase_ops`), one
dot kernel and one fused kernel per phase.  The reference's
``lax.while_loop`` becomes a host loop that reads ``rr`` once per
iteration; every other scalar stays a 0-d device tensor.  With tracing
on (:mod:`repro_torch.core.metrics`) the loop records a ``solve.rr_read``
span around each read and a ``solve.iter`` span around each iteration's
enqueueing, and counts the reads in ``host_syncs``.

Given ``reduce``, every dot is a local partial that ``reduce`` sums over
the ranks sharing the vectors, two barriers an iteration (``p·ap``, then
the packed ``[r·r, r·z]``): the row-distributed solver
(:mod:`repro_torch.distributed.cg_dist`) runs this loop so.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.metrics import solver_metrics
from repro_torch.core.precision import PrecisionScheme

__all__ = ["CGState", "jpcg_loop", "init_state", "vsr_iteration"]


class CGState(NamedTuple):
    i: torch.Tensor       # iteration counter (0-d int32)
    x: torch.Tensor       # current solution
    r: torch.Tensor       # residual
    p: torch.Tensor       # search direction
    rz: torch.Tensor      # (r, z)
    rr: torch.Tensor      # ‖r‖² — the termination scalar
    trace: torch.Tensor   # rr per iteration ((maxiter,) or (0,))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a, b)


def local(*scalars):
    """The ``reduce`` of one system: its dots are already whole."""
    return scalars


def vsr_iteration(matvec, diag, x, r, p, rz, *, dot=_dot, reduce=local,
                  with_aux=False):
    """One VSR-scheduled JPCG iteration (phases 1–3) on raw vectors.

    With a row-wise ``dot`` the vectors carry a leading lane axis and the
    scalars are ``[G]``.  ``reduce(*partials) -> sums`` completes the
    dots, once for ``p·ap`` and once for ``r'·r'`` and ``r'·z``.  Returns
    ``(x', r', p', rz', rr')``; with ``with_aux`` the tick's ``(pap,
    alpha, beta)`` ride along as a sixth element for breakdown detection
    (:mod:`repro_torch.core.metrics`).
    """
    # ---- Phase 1: M1 (SpMV), M2 (dot) -> alpha ----
    ap = matvec(p)
    pap, = reduce(dot(p, ap))
    alpha = rz / pap
    al = alpha[..., None] if alpha.dim() else alpha
    # ---- Phase 2: M4, M8, M5, M6 -> beta ----
    r_new = r - al * ap
    rr_new = dot(r_new, r_new)           # M8 hoisted: early termination
    z = r_new / diag                     # M5 (never stored)
    rz_new = dot(r_new, z)               # M6
    rr_new, rz_new = reduce(rr_new, rz_new)
    beta = rz_new / rz
    be = beta[..., None] if beta.dim() else beta
    # ---- Phase 3: M7, M3 ----
    p_new = z + be * p
    x_new = x + al * p
    if with_aux:
        return x_new, r_new, p_new, rz_new, rr_new, (pap, alpha, beta)
    return x_new, r_new, p_new, rz_new, rr_new


def init_state(matvec, diag, b, x0, *, maxiter: int,
               scheme: PrecisionScheme, with_trace: bool,
               reduce=local) -> CGState:
    """Paper Alg. 1 lines 1–5 (the controller's rp = −1 warm-up pass).
    The dots here are plain ``torch.dot``, as the reference's are
    ``jnp.dot``, completed by one ``reduce``."""
    vd = scheme.vector_dtype
    with solver_metrics().span("solve.init"):
        b = b.to(vd)
        x0 = x0.to(vd)
        r = b - matvec(x0)
        z = r / diag
        p = z
        rz, rr = reduce(_dot(r, z), _dot(r, r))
        trace = torch.zeros(maxiter if with_trace else 0, dtype=vd,
                            device=b.device)
    return CGState(i=torch.zeros((), dtype=torch.int32, device=b.device),
                   x=x0, r=r, p=p, rz=rz, rr=rr, trace=trace)


def jpcg_loop(matvec, diag, state: CGState, *, tol: float, maxiter: int,
              scheme: PrecisionScheme, phase_ops=None,
              reduce=local) -> CGState:
    """Run Alg. 1's main loop until ``rr <= tol`` or ``i == maxiter``.

    The predicate is the reference's ``(i < maxiter) & (rr > tol)`` with
    ``tol`` rounded to ``vector_dtype``, checked before every iteration;
    ``rr`` is the one value read on the host per iteration.

    ``phase_ops`` — optional ``(dot, phase2, phase3)`` triple (see
    :func:`repro_torch.kernels.ops.make_phase_ops`): when given, phase 1
    is the operator's SpMV plus the dot kernel and phases 2 and 3 are one
    fused kernel each, instead of :func:`vsr_iteration`'s eager ops (the
    plain oracle, the reference's ``body_jnp``).  ``reduce`` completes
    the plain body's dots (the kernels' dots are whole).  The input state
    is not modified.
    """
    if phase_ops is not None and reduce is not local:
        raise ValueError("phase_ops computes whole dots: no reduce")
    vd = scheme.vector_dtype
    tol_v = float(torch.tensor(tol, dtype=vd))

    def body_plain(x, r, p, rz):
        return vsr_iteration(matvec, diag, x, r, p, rz, reduce=reduce)

    def body_kernels(x, r, p, rz):
        dot, phase2, phase3 = phase_ops
        # ---- Phase 1: SpMV kernel + dot kernel -> alpha ----
        ap = matvec(p)
        pap = dot(p, ap)
        alpha = rz / pap
        # ---- Phase 2: ONE fused kernel (M4+M8+M5+M6) -> beta ----
        r_new, scal = phase2(alpha, r, ap, diag)
        rr_new, rz_new = scal[0], scal[1]
        beta = rz_new / rz
        # ---- Phase 3: ONE fused kernel (M5-recompute+M7+M3) ----
        p_new, x_new = phase3(alpha, beta, r_new, diag, p, x)
        return x_new, r_new, p_new, rz_new, rr_new

    body = body_plain if phase_ops is None else body_kernels
    m = solver_metrics()
    i = i0 = int(state.i)
    x, r, p, rz, rr = state.x, state.r, state.p, state.rz, state.rr
    trace = state.trace.clone()
    while i < maxiter:
        with m.span("solve.rr_read"):
            go = float(rr) > tol_v
        if not go:
            break
        with m.span("solve.iter"):
            x, r, p, rz, rr = body(x, r, p, rz)
            if trace.shape[0]:
                trace[i] = rr
        i += 1
    # the reads of i and of every rr the predicate checked
    m.count("host_syncs", 1 + (i - i0) + (i < maxiter))
    return CGState(i=torch.tensor(i, dtype=torch.int32, device=x.device),
                   x=x, r=r, p=p, rz=rz, rr=rr, trace=trace)
