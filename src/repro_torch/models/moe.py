"""Mixture-of-experts FFN — the port of :mod:`repro.models.moe`: top-k
routing with capacity, GShard's grouped one-hot dispatch.

Tokens are split into groups of :data:`GROUP` (the last one padded with
zeros); within a group the router (fp32) picks each token's top-k experts,
renormalizes their gates, and ranks each (token, k) pick among the picks of
the same expert by an exclusive cumsum in (token, k) order.  A pick ranked
at or above the capacity ``C = max(1, ceil(group · top_k ·
capacity_factor / E))`` is dropped: its weight is 0, and the surviving
picks' weights are *not* renormalized again (the reference's docstring says
they are; its code, which this follows, does not — ROADMAP C).

Dispatch and combine are one-hot products, as in the reference: exact in
any dtype, since every expert slot holds at most one token and a token
picks an expert at most once.  The expert products are batched matmuls.
The reference's sharding hints pin the groups on ``data`` and the expert
axis on ``model`` (:mod:`repro_torch.distributed.hints`; no-ops without a
mesh).  On DTensors the dispatch, experts and combine are one
``local_map`` region in that layout (:func:`_experts_sharded`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.hints import DATA, MODEL, hint, is_dtensor
from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import Dense, _param, _truncated_normal_

__all__ = ["MoE", "moe_ffn", "route", "GROUP"]

#: tokens per routing group (GShard-style)
GROUP = 1024


class MoE(nn.Module):
    """``router`` (a :class:`~repro_torch.models.layers.Dense` ``[d, E]``)
    and the expert weights stacked on a leading ``E`` axis: ``wi``, ``wg``
    ``[E, d, f]`` and ``wo [E, f, d]``."""

    def __init__(self, d: int, f: int, cfg: MoEConfig, *, device=None):
        super().__init__()
        E = cfg.n_experts
        self.router = Dense(d, E, device=device)
        self.wi = _param(E, d, f, device=device)
        self.wg = _param(E, d, f, device=device)
        self.wo = _param(E, f, d, device=device)

    def reset_parameters(self, generator=None) -> None:
        """The expert weights at the reference's scales (``d ** -0.5`` in,
        ``f ** -0.5`` out); the router draws as its own ``Dense``."""
        d, f = self.wi.shape[1:]
        _truncated_normal_(self.wi, d ** -0.5, generator)
        _truncated_normal_(self.wg, d ** -0.5, generator)
        _truncated_normal_(self.wo, f ** -0.5, generator)


def _top_k(gates: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` orders ties
    arbitrarily on CUDA)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: MoE, xg: torch.Tensor, cfg: MoEConfig):
    """The router on groups ``xg [G, S, D]``: ``(tope, w_kept, pos, cap)``
    — each token's top-k experts ``[G, S, K]``, their renormalized gates
    with the dropped picks' set to 0, each pick's rank among the group's
    picks of its expert, and the capacity (a pick is kept iff
    ``pos < cap``)."""
    g_sz = xg.shape[1]
    E, K = cfg.n_experts, cfg.top_k
    logits = torch.einsum("gsd,de->gse", xg.float(), p.router.w.float())
    gates = torch.softmax(logits, dim=-1)                    # [G, S, E]
    topw, tope = _top_k(gates, K)                            # [G, S, K]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    cap = max(1, math.ceil(g_sz * K * cfg.capacity_factor / E))

    # position of each (token, k) among same-expert picks within the
    # group: exclusive cumsum over the flattened (S, K) order
    sel = F.one_hot(tope, E)                                 # [G, S, K, E]
    flat = sel.reshape(xg.shape[0], g_sz * K, E)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = (pos.reshape(sel.shape) * sel).sum(-1)             # [G, S, K]
    w_kept = torch.where(pos < cap, topw, 0.0)
    return tope, w_kept, pos, cap


def _experts(disp, comb, xg, wi, wg, wo) -> torch.Tensor:
    """Dispatch, the experts' SwiGLU at ``xg``'s dtype, and the combine in
    fp32: [G, S, D]."""
    xe = torch.einsum("gsec,gsd->egcd", disp, xg)            # [E, G, C, D]
    xe = hint(xe, MODEL, DATA, None, None)
    h = F.silu(torch.einsum("egcd,edf->egcf", xe, wg.to(xg.dtype))) \
        * torch.einsum("egcd,edf->egcf", xe, wi.to(xg.dtype))
    ye = torch.einsum("egcf,efd->egcd", h, wo.to(xg.dtype))
    return torch.einsum("gsec,egcd->gsd", comb, ye.float())


def _experts_sharded(disp, comb, xg, p: MoE) -> torch.Tensor:
    """:func:`_experts` on each rank's groups and experts (``local_map``):
    the layout the reference's hint gives ``xe`` (experts on ``model``,
    groups on ``data``).  Groups are independent and experts add, so each
    rank runs its experts, their weights gathered whole over the other
    axes, on its groups; the result is a ``Partial`` sum over the expert
    shards.  The inputs' gradients are ``Partial`` where ranks each add a
    part: ``xg``'s over the expert shards, the weights' over the group
    shards.  DTensor's einsum rules flatten two sharded dims, which torch
    2.11 refuses even on a (1, 1) mesh."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    groups = [q.is_shard(0) for q in xg.placements]
    experts = [q.is_shard(0) and not g
               for q, g in zip(p.wi.placements, groups)]

    def pl(on_groups, on_experts):
        return [on_groups if g else on_experts if e else Replicate()
                for g, e in zip(groups, experts)]
    onehot, rows = pl(Shard(0), Shard(2)), pl(Shard(0), Replicate())
    w, w_grad = pl(Replicate(), Shard(0)), pl(Partial(), Shard(0))
    return local_map(
        _experts, out_placements=pl(Shard(0), Partial()),
        in_placements=(onehot, onehot, rows, w, w, w),
        in_grad_placements=(onehot, onehot, pl(Shard(0), Partial()),
                            w_grad, w_grad, w_grad),
        redistribute_inputs=True)(disp, comb, xg, p.wi, p.wg, p.wo)


def moe_ffn(p: MoE, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D].  Router and combine in fp32, the expert
    products at ``x``'s dtype."""
    b, s, d = x.shape
    n = b * s
    g_sz = min(GROUP, n)
    n_pad = math.ceil(n / g_sz) * g_sz
    xt = x.reshape(n, d)
    if n_pad != n:
        xt = torch.cat([xt, xt.new_zeros(n_pad - n, d)], dim=0)
    xg = hint(xt.reshape(n_pad // g_sz, g_sz, d), DATA, None, None)

    tope, w_kept, pos, cap = route(p, xg, cfg)
    sel = F.one_hot(tope, cfg.n_experts)                     # [G, S, K, E]
    # one_hot(cap, cap) is a zero row in JAX; F.one_hot needs the class
    pos_oh = F.one_hot(torch.where(pos < cap, pos, cap), cap + 1)[..., :cap]
    disp = torch.einsum("gske,gskc->gsec", sel.to(x.dtype),
                        pos_oh.to(x.dtype))                  # [G, S, E, C]
    # the reference's "gske,gskc,gsk->gsec" with w_kept folded into sel
    # first (exact: one k per (token, expert)), so no [G,S,K,E,C] product
    comb = torch.einsum("gske,gskc->gsec", sel * w_kept[..., None],
                        pos_oh.float())

    y = _experts_sharded(disp, comb, xg, p) if is_dtensor(xg) \
        else _experts(disp, comb, xg, p.wi, p.wg, p.wo)      # [G, S, D]
    # cast before the group -> batch reshape, and pin the layout
    y = hint(y.to(x.dtype), DATA, None, None).reshape(n_pad, d)[:n]
    return hint(y.reshape(b, s, d), DATA, None, None)
