"""Pipelined JPCG (Ghysels–Vanroose), the port of
:mod:`repro.core.pipelined`.

The recurrence computes its three scalars (γ = r·u, δ = w·u, ‖r‖²) in
one fused reduction per iteration, and its SpMV (n = A·m) does not wait
for that reduction — the variant meant for settings where each reduction
is a latency-bound all-reduce.  Cost per iteration: 20 vector accesses
(11R + 9W) and one reduction, against the VSR loop's 13–14 and two.

Pipelined CG's recurrences lose accuracy faster than true-residual CG;
every ``replace_every`` iterations (:data:`REPLACE_EVERY` by default) the
residual is replaced (r = b − A·x and the dependent u, w recomputed), as
in the reference.

Given ``reduce``, the three dots are local partials that one ``reduce``
sums over the ranks sharing the vectors: the row-distributed solver
(:mod:`repro_torch.distributed.cg_dist`) runs this loop so.

Plain PyTorch throughout, like the reference's jnp: the reduction is the
plain :func:`_dots3`, not the ``dot3`` kernel (the reference's loop does
not call ``dot3_pallas`` either); with ``backend="pallas"`` the matvec is
the SpMV kernel.  The host loop reads ``rr`` once per iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.metrics import solver_metrics
from repro_torch.core.phases import local
from repro_torch.core.precision import PrecisionScheme

__all__ = ["PipeCGState", "pipecg_init", "pipecg_loop", "REPLACE_EVERY"]

#: Iterations between residual replacements (the reference's default).
REPLACE_EVERY = 50


class PipeCGState(NamedTuple):
    i: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor   # residual
    u: torch.Tensor   # M⁻¹ r
    w: torch.Tensor   # A u
    z: torch.Tensor   # A q-direction accumulator
    q: torch.Tensor   # M⁻¹ p accumulator
    s: torch.Tensor   # A p accumulator
    p: torch.Tensor   # search direction
    gamma: torch.Tensor       # (r, u)
    gamma_prev: torch.Tensor
    delta: torch.Tensor       # (w, u)
    alpha_prev: torch.Tensor
    rr: torch.Tensor          # ‖r‖²
    trace: torch.Tensor


def _dots3(r, u, w, reduce):
    """The single fused reduction: γ, δ, ‖r‖² (three plain dots)."""
    return reduce(torch.dot(r, u), torch.dot(w, u), torch.dot(r, r))


def pipecg_init(matvec, diag, b, x0, *, maxiter: int, scheme: PrecisionScheme,
                with_trace: bool, reduce=local) -> PipeCGState:
    vd = scheme.vector_dtype
    b = b.to(vd)
    x = x0.to(vd)
    r = b - matvec(x)
    u = r / diag
    w = matvec(u)
    gamma, delta, rr = _dots3(r, u, w, reduce)
    zero = torch.zeros_like(r)
    one = torch.ones((), dtype=vd, device=r.device)
    trace = torch.zeros(maxiter if with_trace else 0, dtype=vd,
                        device=r.device)
    return PipeCGState(i=torch.zeros((), dtype=torch.int32, device=r.device),
                       x=x, r=r, u=u, w=w, z=zero, q=zero, s=zero, p=zero,
                       gamma=gamma, gamma_prev=one, delta=delta,
                       alpha_prev=one, rr=rr, trace=trace)


def pipecg_loop(matvec, diag, b, state: PipeCGState, *, tol: float,
                maxiter: int, scheme: PrecisionScheme,
                replace_every: int = REPLACE_EVERY,
                reduce=local) -> PipeCGState:
    """Iterate until ``rr <= tol`` (at ``vector_dtype``) or ``i == maxiter``;
    ``reduce`` completes each iteration's three dots in one call.  The
    input state is not modified."""
    vd = scheme.vector_dtype
    tol_v = float(torch.tensor(tol, dtype=vd))
    b = b.to(vd)
    every = max(replace_every, 1)
    st = state._replace(trace=state.trace.clone())
    i = i0 = int(st.i)
    while i < maxiter and float(st.rr) > tol_v:
        # -- overlap region: this SpMV is independent of the dots of step i --
        m = st.w / diag                      # M⁻¹ w
        n = matvec(m)                        # A m
        if i == 0:
            beta = torch.zeros((), dtype=vd, device=m.device)
            alpha = st.gamma / st.delta
        else:
            beta = st.gamma / st.gamma_prev
            denom = st.delta - beta * st.gamma / st.alpha_prev
            alpha = st.gamma / denom
        # -- the 8-vector update sweep --
        z = n + beta * st.z
        q = m + beta * st.q
        s = st.w + beta * st.s
        p = st.u + beta * st.p
        x = st.x + alpha * p
        r = st.r - alpha * s
        u = st.u - alpha * q
        w = st.w - alpha * z
        # -- periodic residual replacement for FP64-grade stability --
        if replace_every > 0 and i % every == every - 1:
            r = b - matvec(x)
            u = r / diag
            w = matvec(u)
        gamma, delta, rr = _dots3(r, u, w, reduce)     # THE reduction
        if st.trace.shape[0]:
            st.trace[i] = rr
        i += 1
        st = PipeCGState(i=st.i, x=x, r=r, u=u, w=w, z=z, q=q, s=s, p=p,
                         gamma=gamma, gamma_prev=st.gamma, delta=delta,
                         alpha_prev=alpha, rr=rr, trace=st.trace)
    # the reads of i and of every rr the predicate checked
    solver_metrics().count("host_syncs", 1 + (i - i0) + (i < maxiter))
    return st._replace(i=torch.tensor(i, dtype=torch.int32,
                                      device=st.x.device))
