"""Optimizers — AdamW (with bf16 moment storage) and schedules (the torch
port of :mod:`repro.train.optim`).

``state_dtype="bfloat16"`` stores the Adam moments one precision tier
below the fp32 iterate — the paper's Mix-V3 principle ("store the operator
stream low, keep the iterate high") applied to optimizer state; the update
math runs in fp32.  Plain functions on ``{name: tensor}`` dicts under
``torch.no_grad()``, in the reference's arithmetic order (not a
``torch.optim.Optimizer``, whose arithmetic differs): clip by the global
norm first, bias correction from the incremented step, weight decay on
leaves with ``ndim >= 2`` only (:func:`decays`, by the reference's leaf
shapes: :func:`matrix_leaf`).  Parameters and moments are updated in
place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple

import torch

from repro_torch.core.gn import param_dict
from repro_torch.models.transformer import dtype_of

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm", "decays",
           "matrix_leaf"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "bfloat16"    # moment storage (beyond-paper Mix-V3)


class AdamWState(NamedTuple):
    step: torch.Tensor               # 0-d int32, on the host
    m: Dict[str, torch.Tensor]       # {name: moment}, the parameters' names
    v: Dict[str, torch.Tensor]


#: the LM stacks the reference stacks on a leading layer axis
_STACKED = ("layers.", "enc_layers.", "dec_layers.")


def matrix_leaf(name: str, p: torch.Tensor) -> bool:
    """Whether ``p`` is a leaf of ``ndim >= 2`` by the reference's leaf
    shapes: the reference stacks an LM's layers, so a parameter of layer l
    (``layers.<l>.…``, or the encoder-decoder's ``enc_layers.<l>.…`` and
    ``dec_layers.<l>.…``) is one slice of an ``[L, …]`` leaf there and
    counts that axis — its per-layer norm gains and biases are matrices;
    ``ln_f.g``, ``enc_ln.g`` and a dict's 1-D leaves are not."""
    return p.ndim + name.startswith(_STACKED) >= 2


#: weight decay on matrices only: the per-layer norm gains and biases
#: decay, as the reference's do
decays = matrix_leaf


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments at ``cfg.state_dtype`` for a module or a
    ``{name: tensor}`` mapping (:func:`~repro_torch.core.gn.param_dict`),
    each laid out as its parameter (a DTensor parameter's moments are
    DTensors with its placements)."""
    dt = dtype_of(cfg.state_dtype)
    leaves = param_dict(params)
    zeros = lambda: {n: torch.zeros_like(p, dtype=dt)  # noqa: E731
                     for n, p in leaves.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32), m=zeros(),
                      v=zeros())


def global_norm(tree) -> torch.Tensor:
    """``sqrt(Σ g²)`` over every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in param_dict(tree).values()))


def clip_by_global_norm(tree, max_norm: float):
    """``(tree · min(1, max_norm / ‖tree‖), ‖tree‖)``, a new dict."""
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {n: (g.float() * scale).to(g.dtype)
            for n, g in param_dict(tree).items()}, gn


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig, lr):
    """One AdamW step: moments stored at ``cfg.state_dtype``, math in fp32.
    ``params`` (a module or a mapping) and the state's moments are updated
    in place; returns ``(params, new_state)``."""
    if cfg.grad_clip:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    grads = param_dict(grads)
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    s = step.float()
    c1 = 1.0 - b1 ** s
    c2 = 1.0 - b2 ** s
    for name, p in param_dict(params).items():
        m, v = state.m[name], state.v[name]
        g32 = grads[name].float()
        m32 = m.float() * b1 + g32 * (1 - b1)
        v32 = v.float() * b2 + g32 * g32 * (1 - b2)
        mhat = m32 / c1
        vhat = v32 / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decays(name, p):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, AdamWState(step=step, m=state.m, v=state.v)


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """Linear warmup to ``base_lr``, then a cosine to 0 at ``total``:
    ``lr(step)`` is a 0-d fp32 tensor on the host."""
    def lr(step) -> torch.Tensor:
        s = torch.as_tensor(step).float()
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return lr
