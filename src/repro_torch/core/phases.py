"""Phase-structured JPCG iteration (the torch port of
:func:`repro.core.phases.vsr_iteration`).

* **Phase 1**: M1 SpMV (``ap = A·p``) then M2 dot (``pap = p·ap``) —
  barrier: ``alpha = rz / pap``.
* **Phase 2**: ``r' = r − α·ap`` (M4), ``rr = r'·r'`` (M8, hoisted for
  early termination), ``z = M⁻¹·r'`` (M5), ``rz' = r'·z`` (M6) —
  barrier: ``beta = rz'/rz``.
* **Phase 3**: ``p' = z + β·p`` (M7), ``x' = x + α·p`` (M3).

The batched phases engine (:mod:`repro_torch.core.batch`) runs this on
``[G, n]`` lanes with a row-wise dot; it is the oracle the stream VM
(:mod:`repro_torch.core.vm`) is held to bitwise.  Every product and sum
is its own eager op, so no step fuses into a contracted multiply-add and
the VM's word-by-word spelling of the same arithmetic lands on the same
bits.
"""
from __future__ import annotations

import torch

__all__ = ["vsr_iteration"]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a, b)


def vsr_iteration(matvec, diag, x, r, p, rz, *, dot=_dot, with_aux=False):
    """One VSR-scheduled JPCG iteration (phases 1–3) on raw vectors.

    With a row-wise ``dot`` the vectors carry a leading lane axis and the
    scalars are ``[G]``.  Returns ``(x', r', p', rz', rr')``; with
    ``with_aux`` the tick's ``(pap, alpha, beta)`` ride along as a sixth
    element for breakdown detection (:mod:`repro_torch.core.metrics`).
    """
    # ---- Phase 1: M1 (SpMV), M2 (dot) -> alpha ----
    ap = matvec(p)
    pap = dot(p, ap)
    alpha = rz / pap
    al = alpha[..., None] if alpha.dim() else alpha
    # ---- Phase 2: M4, M8, M5, M6 -> beta ----
    r_new = r - al * ap
    rr_new = dot(r_new, r_new)           # M8 hoisted: early termination
    z = r_new / diag                     # M5 (never stored)
    rz_new = dot(r_new, z)               # M6
    beta = rz_new / rz
    be = beta[..., None] if beta.dim() else beta
    # ---- Phase 3: M7, M3 ----
    p_new = z + be * p
    x_new = x + al * p
    if with_aux:
        return x_new, r_new, p_new, rz_new, rr_new, (pap, alpha, beta)
    return x_new, r_new, p_new, rz_new, rr_new
