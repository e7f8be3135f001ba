"""Matrix-free Gauss–Newton operators — the solver ↔ LM-training bridge
(the torch port of :mod:`repro.core.gn`).

The CGGN (Hessian-free) optimizer solves ``(G + λI) δ = −g`` each step,
where ``G = Jᵀ H_L J`` is the generalized Gauss–Newton matrix of the loss:
SPD and never materialized.  ``G·v`` is a jvp through the model, a jvp of
the loss's gradient in the logits (``H_L``) and a vjp back — the operator
class JPCG consumes.  The matvec runs at the model's compute dtype while
the CG vectors stay fp32 (:mod:`repro_torch.train.cggn`).

Parameters are a flat vector of the names a ``torch.func.functional_call``
takes (:func:`flatten_like`).  The Jacobi preconditioner is the diagonal of
``G + λI`` from Hutchinson probes: ``diag(G) ≈ E[e ⊙ (G e)]`` over
Rademacher ``e``.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple, Union

import torch
from torch import nn
from torch.func import grad, jvp, vjp

__all__ = ["make_ggn_matvec", "estimate_jacobi_diag", "flatten_like",
           "param_dict"]

Params = Union[nn.Module, Mapping[str, object]]


def param_dict(params: Params) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` in a fixed order: a module's
    ``named_parameters()`` order (its ``functional_call`` names); a
    mapping's own order, nested mappings' names joined with ``"."``.
    (``jax.tree_util`` sorts a dict's keys: a mapping built in sorted
    order ravels as the reference's.)  Module parameters come detached (the
    same storage)."""
    if isinstance(params, nn.Module):
        return {n: p.detach() for n, p in params.named_parameters()}
    out = {}
    for key, val in params.items():
        if isinstance(val, Mapping):
            out.update((f"{key}.{n}", t) for n, t in param_dict(val).items())
        else:
            out[key] = val
    return out


def _ravel_unravel(params: Params):
    """``(ravel, unravel, n)`` of :func:`flatten_like`, without raveling
    anything."""
    leaves = param_dict(params)
    names = list(leaves)
    shapes = [leaves[n].shape for n in names]
    sizes = [leaves[n].numel() for n in names]
    dtypes = [leaves[n].dtype for n in names]
    dtype = dtypes[0] if dtypes else torch.float32
    for dt in dtypes[1:]:
        dtype = torch.promote_types(dtype, dt)

    def ravel(tree) -> torch.Tensor:
        d = param_dict(tree)
        return torch.cat([d[n].reshape(-1).to(dtype) for n in names])

    def unravel(v: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: part.view(sh).to(dt) for n, part, sh, dt in
                zip(names, torch.split(v, sizes), shapes, dtypes)}

    return ravel, unravel, sum(sizes)


def flatten_like(params: Params):
    """``(flat, ravel, unravel)`` for the parameters' order
    (:func:`param_dict`).

    ``flat`` is every parameter raveled and concatenated at the widest
    floating dtype among them (the reference's ``result_type``);
    ``ravel(tree)`` does the same for any tree with those names (a module,
    a mapping, the dict of gradients ``torch.func`` returns);
    ``unravel(v)`` gives ``{name: view}``: ``split`` + ``view``, no copy,
    unless a parameter's dtype differs from ``v``'s.
    """
    ravel, unravel, _ = _ravel_unravel(params)
    return ravel(params), ravel, unravel


def make_ggn_matvec(loss_logits_fn: Callable, logits_fn: Callable,
                    params: Params, damping: float = 1e-3
                    ) -> Tuple[Callable, int]:
    """Build ``v ↦ (G + λI)·v`` for ``G = Jᵀ H_L J`` in the flat parameter
    space of :func:`flatten_like`.

    ``logits_fn(p) -> logits`` is the model on a fixed batch, ``p`` a
    ``{name: tensor}`` dict (:func:`param_dict`'s names: for a module, call
    it through ``torch.func.functional_call``); ``loss_logits_fn(logits)
    -> scalar`` is the loss in the logits, so ``H_L`` is the small
    per-logit Hessian (PSD for cross entropy and squared error).

    ``J v`` is ``torch.func.jvp`` through ``logits_fn`` and ``H_L (J v)``
    a ``jvp`` of ``torch.func.grad(loss_logits_fn)``.  ``Jᵀ u`` is the vjp
    of one ``torch.func.vjp`` taken here, once: the reference re-traces it
    per matvec, where XLA shares the forward; the port keeps the one
    forward's saved activations for every matvec of the step.  The model
    must run without activation checkpointing here: ``torch.func`` refuses
    the saved-tensor hooks of ``torch.utils.checkpoint``
    (``Transformer.forward`` and ``Hybrid.forward`` run so).
    """
    primals = param_dict(params)
    ravel, unravel, n = _ravel_unravel(primals)
    _, pullback = vjp(logits_fn, primals)
    grad_loss = grad(loss_logits_fn)

    def matvec(v: torch.Tensor) -> torch.Tensor:
        logits, jv = jvp(logits_fn, (primals,), (unravel(v),))
        _, hjv = jvp(grad_loss, (logits,), (jv,))
        del logits, jv
        (gv,) = pullback(hjv)
        flat = ravel(gv)
        del gv
        return flat.add_(damping * v.to(flat.dtype))

    return matvec, n


def _rademacher(n: int, generator: torch.Generator,
                dtype: torch.dtype) -> torch.Tensor:
    """One probe of ±1 (each with probability ½), on the generator's
    device."""
    e = torch.empty(n, dtype=dtype, device=generator.device)
    return e.bernoulli_(0.5, generator=generator).mul_(2).sub_(1)


def estimate_jacobi_diag(matvec: Callable, n: int,
                         generator: torch.Generator, probes: int = 8,
                         damping: float = 1e-3,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Hutchinson estimate of ``diag(G) + λ``, clipped at ``damping`` (the
    SPD guard).  The reference maps all probes at once; at full width each
    is a vector of the parameter count, so the probes run one after
    another into one sum."""
    est = None
    for _ in range(probes):
        e = _rademacher(n, generator, dtype)
        e.mul_(matvec(e))
        est = e if est is None else est.add_(e)
    return est.div_(probes).clamp_min_(damping)
