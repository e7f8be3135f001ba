"""CGGN — Hessian-free Gauss–Newton with the JPCG inner solver (the torch
port of :mod:`repro.train.cggn`).

Each update solves

    (G + λI) δ = −g ,     G = Jᵀ H_L J   (SPD, matrix-free)

with the paper's Jacobi-preconditioned CG — the port's own three-phase
loop (:func:`repro_torch.core.phases.init_state` and ``jpcg_loop``), with
its on-the-fly termination — where the matvec is the GGN operator of
:mod:`repro_torch.core.gn`.  The precision follows the scheme: the matvec
takes its input at ``spmv_in_dtype`` and runs at the model's compute dtype
(the low "matrix stream"), the CG vectors stay at ``vector_dtype``.

The Jacobi diagonal is a Hutchinson estimate refreshed every
``refresh_precond`` steps (a host ``if``: the step count lives on the
host); its probes come from a generator seeded by ``(seed, step)``, so the
state is three plain values.  A trust region rescales δ to at most
``max_delta_norm``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import phases as _phases
from repro_torch.core.gn import (estimate_jacobi_diag, flatten_like,
                                 make_ggn_matvec, param_dict)
from repro_torch.core.precision import get_scheme
from repro_torch.train.data import step_generator

__all__ = ["CGGNConfig", "CGGNState", "cggn_init", "cggn_update",
           "cg_solve_matfree"]


@dataclasses.dataclass(frozen=True)
class CGGNConfig:
    lr: float = 1.0
    damping: float = 1e-2
    cg_iters: int = 16
    cg_tol: float = 1e-8
    probes: int = 4
    scheme: str = "tpu_v3"
    refresh_precond: int = 10
    max_delta_norm: float = 10.0     # trust region: rescale ‖δ‖ above this


class CGGNState(NamedTuple):
    step: int                # updates taken
    seed: int                # the probes' generator: seeded by (seed, step)
    diag: torch.Tensor       # cached Jacobi estimate (flat param space)


def cg_solve_matfree(matvec, diag, b, *, tol: float, maxiter: int,
                     scheme) -> _phases.CGState:
    """JPCG from x0 = 0 on a callable operator: the single-system solver's
    own ``init_state`` and ``jpcg_loop``.  Returns the final
    :class:`~repro_torch.core.phases.CGState` (``.x`` the solution,
    ``.i`` the iterations taken)."""
    scheme = get_scheme(scheme)
    st = _phases.init_state(matvec, diag, b, torch.zeros_like(b),
                            maxiter=maxiter, scheme=scheme, with_trace=False)
    return _phases.jpcg_loop(matvec, diag, st, tol=tol, maxiter=maxiter,
                             scheme=scheme)


def cggn_init(params, seed: int) -> CGGNState:
    """Step 0, the probes' seed and a diagonal of ones on the parameters'
    device."""
    leaves = param_dict(params)
    n = sum(t.numel() for t in leaves.values())
    dev = next(iter(leaves.values())).device
    return CGGNState(step=0, seed=int(seed),
                     diag=torch.ones(n, dtype=torch.float32, device=dev))


def _norm(v: torch.Tensor) -> torch.Tensor:
    """‖v‖ in fp32 as ``sqrt(v·v)``: on the CPU ``torch.linalg.vector_norm``
    sums fp32 squares without a cascade (‖g‖ of 3.5 M entries 3e-4 low);
    ``dot`` keeps 1e-6, and copies nothing."""
    v = v.float()
    return torch.sqrt(torch.dot(v, v))


@torch.no_grad()
def _apply(params, delta: torch.Tensor, lr: float) -> None:
    """``θ ← θ + lr·δ``, parameter by parameter, in place."""
    leaves = param_dict(params).values()
    for t, d in zip(leaves, torch.split(delta, [t.numel() for t in leaves])):
        t.add_(lr * d.view_as(t).to(t.dtype))


def cggn_update(params, state: CGGNState, *, loss_logits_fn, logits_fn,
                loss_value_and_grad, cfg: CGGNConfig):
    """One CGGN step.

    ``params`` is a module or a ``{name: tensor}`` mapping
    (:func:`~repro_torch.core.gn.param_dict`); it is updated in place and
    returned.  ``loss_value_and_grad(p) -> (loss, grads)`` is the usual
    backward on the dict ``p`` (grads a dict of the same names);
    ``logits_fn(p) -> logits`` and ``loss_logits_fn(logits) -> scalar``
    define the GGN factorization on the same batch.
    Returns ``(params, new_state, metrics)``: ``loss``, ``delta_norm``,
    ``grad_norm`` (0-d tensors) and ``cg_iters`` (the inner CG's
    iterations).
    """
    scheme = get_scheme(cfg.scheme)
    primals = param_dict(params)
    loss, grads = loss_value_and_grad(primals)
    gflat, _, _ = flatten_like(grads)
    del grads
    gflat = gflat.to(scheme.vector_dtype)
    grad_norm = _norm(gflat)

    matvec_tree, n = make_ggn_matvec(loss_logits_fn, logits_fn, primals,
                                     damping=cfg.damping)

    def matvec(v):
        return matvec_tree(v.to(scheme.spmv_in_dtype)).to(
            scheme.vector_dtype)

    if state.step % cfg.refresh_precond == 0:
        # the reference splits a key per step; here the probes' generator
        # is seeded by (seed, step)
        gen = step_generator(state.seed, state.step, gflat.device)
        diag = estimate_jacobi_diag(matvec, n, gen, probes=cfg.probes,
                                    damping=cfg.damping).float()
    else:
        diag = state.diag

    st = cg_solve_matfree(matvec, diag.to(scheme.vector_dtype),
                          gflat.neg_(), tol=cfg.cg_tol,
                          maxiter=cfg.cg_iters, scheme=scheme)
    del gflat, matvec, matvec_tree      # the pullback's saved activations
    delta, iters = st.x, int(st.i)
    del st
    # trust region: GN steps on non-quadratic losses can overshoot badly;
    # rescale to max_delta_norm (standard Hessian-free practice)
    dnorm = _norm(delta)
    scale = torch.clamp(cfg.max_delta_norm / torch.clamp(dnorm, min=1e-9),
                        max=1.0)
    delta = delta * scale.to(delta.dtype)
    _apply(params, delta, cfg.lr)
    metrics = {"loss": loss,
               "delta_norm": _norm(delta),
               "grad_norm": grad_norm, "cg_iters": iters}
    return params, CGGNState(step=state.step + 1, seed=state.seed,
                             diag=diag), metrics
