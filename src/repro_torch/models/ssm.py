"""Mamba2 (SSD — state-space duality) layer, chunked matmul form + decode;
the port of :mod:`repro.models.ssm`.

The SSD algorithm [arXiv:2405.21060] computes the selective-SSM recurrence

    h_t = exp(A·dt_t) h_{t-1} + dt_t · B_t ⊗ x_t ,   y_t = C_t · h_t + D·x_t

in a chunk-quadratic / cross-chunk-linear form: within a chunk of length Q
the interaction is a masked [Q, Q] product (a decayed attention score), and
the chunk boundary states are carried by a short loop over the chunks (the
reference's ``lax.scan``).  Training and prefill use chunks; decode holds
the O(H·P·N) state.  Head dim P = ``headdim``, state N = ``d_state``,
H = d_inner / P heads, one B/C group.

One departure, in the derivative only: the reference takes
``exp(cum_i − cum_j)`` over the whole [Q, Q] square and masks the product
afterwards; above the diagonal the exponent is positive and, for chunks of
128 or more, overflows fp32, so its backward computes 0 · inf = NaN.  Here
the exponent's argument is masked first (``exp(where(mask, cum_i − cum_j,
0))``) and the product is masked as the reference masks it.  The forward
is the reference's value for value (every kept entry comes from the same
operations, every other is zeroed by the same ``where``), and the gradient
is the reference's wherever that is finite (ROADMAP C).

On a mesh the heads are hinted onto ``model`` as the reference's are;
the decode step copies its new state into a sharded cache after laying it
out as the cache is (``hints.as_layout``: DTensor copies in place only
between equal layouts).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.hints import (DATA, MODEL, as_layout, hint,
                                           is_dtensor, per_channel, pin,
                                           split_ready)
from repro_torch.models.config import SSMConfig
from repro_torch.models.layers import (Dense, RMSNorm, _param,
                                       _truncated_normal_, dense, rmsnorm)

__all__ = ["Mamba2", "mamba2_forward", "SSMCache", "init_ssm_cache",
           "mamba2_decode", "softplus"]


class Mamba2(nn.Module):
    """``in_proj`` (z, x, B, C, dt packed in one projection), the depthwise
    causal conv ``conv_w [K, C]`` and ``conv_b``, the per-head ``A_log``,
    ``D`` and ``dt_bias``, the gated ``norm`` and ``out_proj``: the
    reference's keys."""

    def __init__(self, d_model: int, cfg: SSMConfig, *, device=None):
        super().__init__()
        di = cfg.d_inner(d_model)
        h = cfg.n_ssm_heads(d_model)
        n = cfg.d_state
        conv_ch = di + 2 * n
        self.in_proj = Dense(d_model, 2 * di + 2 * n + h, device=device)
        self.conv_w = _param(cfg.d_conv, conv_ch, device=device)
        self.conv_b = _param(conv_ch, device=device)
        self.A_log = _param(h, device=device)
        self.D = _param(h, device=device)
        self.dt_bias = _param(h, device=device)
        self.norm = RMSNorm(di, device=device)
        self.out_proj = Dense(di, d_model, device=device)

    def reset_parameters(self, generator=None) -> None:
        """``conv_w`` at scale ``K ** -0.5``; ``A_log = 0`` (A = −1),
        ``D = 1``, ``conv_b = dt_bias = 0``; the projections and the norm
        draw as their own modules."""
        _truncated_normal_(self.conv_w, self.conv_w.shape[0] ** -0.5,
                           generator)
        self.conv_b.zero_()
        self.A_log.zero_()
        self.D.fill_(1.0)
        self.dt_bias.zero_()


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` (``F.softplus`` returns
    ``x`` itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(u: torch.Tensor, di: int, n: int, h: int):
    return u[..., :di], u[..., di: di + di + 2 * n], u[..., -h:]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width K.  xbc: [B, S, C]; w: [K, C].

    Returns (out [B, S, C], final (K-1)-tap state [B, K-1, C])."""
    k = w.shape[0]
    pad = init_state if init_state is not None else xbc.new_zeros(
        xbc.shape[0], k - 1, xbc.shape[2])
    xp = torch.cat([pad, xbc], dim=1)
    out = sum(xp[:, i: i + xbc.shape[1]] * w[i].to(xbc.dtype)
              for i in range(k))
    out = out + b.to(xbc.dtype)
    return F.silu(out), xp[:, -(k - 1):]


def _ssd_chunked(x, dt, a_head, B, C, chunk: int,
                 h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x [b,s,h,p]; dt [b,s,h] (post-softplus); a_head [h] (negative);
    B, C [b,s,n].  Returns (y [b,s,h,p] fp32, h_last [b,h,p,n] fp32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    if s % q:                                  # pad the tail chunk
        padlen = nc * q - s
        x = F.pad(x, (0, 0, 0, 0, 0, padlen))
        dt = F.pad(dt, (0, 0, 0, padlen))
        B = F.pad(B, (0, 0, 0, padlen))
        C = F.pad(C, (0, 0, 0, padlen))
    xq = x.reshape(b, nc, q, h, p).float()
    dtq = dt.reshape(b, nc, q, h).float()
    Bq = B.reshape(b, nc, q, n).float()
    Cq = C.reshape(b, nc, q, n).float()

    a = dtq * a_head.float()                              # [b,nc,q,h] ≤ 0
    cum = torch.cumsum(a, dim=2)                          # inclusive
    # ---- intra-chunk (masked decayed attention) ----
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b,nc,q,q,h]
    decay = torch.exp(torch.where(mask, diff, 0.0))       # no exp(+big)
    g = torch.einsum("bcin,bcjn->bcij", Cq, Bq)
    w = g[..., None] * decay * dtq[:, :, None, :, :]
    w = torch.where(mask, w, 0.0)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xq)

    # ---- chunk summary states ----
    seg = torch.exp(cum[:, :, -1:, :] - cum)              # [b,nc,q,h]
    s_c = torch.einsum("bcqhp,bcqn->bchpn", (seg * dtq)[..., None] * xq,
                       Bq)                                # [b,nc,h,p,n]
    chunk_decay = torch.exp(cum[:, :, -1, :])             # [b,nc,h]

    # ---- cross-chunk recurrence: each chunk sees its PRE-state ----
    hprev = (x.new_zeros(b, h, p, n, dtype=torch.float32) if h0 is None
             else h0.float())
    prevs = []
    for c in range(nc):
        prevs.append(hprev)
        hprev = chunk_decay[:, c, :, None, None] * hprev + s_c[:, c]
    h_prevs = torch.stack(prevs, dim=1)                   # [b,nc,h,p,n]

    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cq, h_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, nc * q, h, p)[:, :s]
    return y, hprev


def _ssd_sharded(xh, dt, a_head, B, C, chunk: int, h0=None):
    """:func:`_ssd_chunked` on each rank's shard (``local_map``): batch and
    heads are independent, so each rank scans its own rows and heads,
    reading B and C whole over the head shards (their gradients a
    ``Partial`` there) and its heads' ``a_head`` (a ``Partial`` over the
    batch shards).  DTensor's own rules search a layout for every einsum
    of the scan, which takes minutes on a 2×16×16 mesh, and flatten two
    sharded dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pl = list(xh.placements)
    batch = [p.is_shard(0) for p in pl]
    head = [p.is_shard(2) for p in pl]
    rows = [Shard(0) if b else Replicate() for b in batch]
    heads = [Shard(0) if hd else Replicate() for hd in head]
    dts = [Shard(0) if b else Shard(2) if hd else Replicate()
           for b, hd in zip(batch, head)]
    shared = [Partial() if hd else p for p, hd in zip(rows, head)]
    state = [Shard(0) if b else Shard(1) if hd else Replicate()
             for b, hd in zip(batch, head)]
    args, in_pl = [xh, dt, a_head, B, C], [pl, dts, heads, rows, rows]
    grad_pl = [pl, dts, [Shard(0) if hd else Partial() if b else Replicate()
                         for b, hd in zip(batch, head)], shared, shared]
    if h0 is not None:
        args.append(h0)
        in_pl.append(state)
        grad_pl.append(state)
    return local_map(
        lambda *t: _ssd_chunked(*t[:5], chunk, t[5] if len(t) > 5 else None),
        out_placements=(pl, state), in_placements=tuple(in_pl),
        in_grad_placements=tuple(grad_pl), redistribute_inputs=True)(*args)


def mamba2_forward(p: Mamba2, x: torch.Tensor, d_model: int, cfg: SSMConfig,
                   *, norm_eps: float = 1e-6,
                   conv_state: Optional[torch.Tensor] = None,
                   ssm_state: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """Full-sequence Mamba2 block (pre-norm residual NOT included).

    x: [B, S, D] -> [B, S, D]  (+ (conv_state, ssm_state) if requested).
    """
    di = cfg.d_inner(d_model)
    n = cfg.d_state
    h = cfg.n_ssm_heads(d_model)

    u = dense(p.in_proj, x)
    z, xbc, dt = _split_proj(u, di, n, h)
    xbc, conv_out_state = _causal_conv(xbc, p.conv_w, p.conv_b, conv_state)
    xc = xbc[..., :di]
    B = xbc[..., di: di + n]
    C = xbc[..., di + n:]

    dt = softplus(dt.float() + p.dt_bias.float())
    a_head = -torch.exp(p.A_log.float())
    xh = split_ready(xc, -1, h).reshape(*xc.shape[:-1], h, cfg.headdim)
    # SSD heads shard on `model`: the chunk-quadratic decay tensor
    # [b, nc, q, q, h] is the biggest live tensor and divides by heads
    xh = hint(xh, DATA, None, MODEL, None)
    dt = hint(dt, DATA, None, MODEL)
    if is_dtensor(xh):
        y, h_last = _ssd_sharded(xh, dt, a_head, B, C, cfg.chunk, ssm_state)
    else:
        y, h_last = _ssd_chunked(xh, dt, a_head, B, C, cfg.chunk, ssm_state)
    y = y + p.D.float()[:, None] * xh.float()
    y = pin(y.reshape(*x.shape[:-1], di)).to(x.dtype)
    y = rmsnorm(p.norm, y, norm_eps) * F.silu(z)
    out = dense(p.out_proj, y)
    if return_state:
        return out, (conv_out_state, h_last.to(x.dtype))
    return out


# ------------------------------------------------------------------ decode
@dataclasses.dataclass
class SSMCache:
    """Per-layer decode state (or a stack of layers', on a leading axis):
    conv taps ``[B, K-1, C]`` + SSM state ``[B, H, P, N]`` — constant in
    sequence length."""
    conv: torch.Tensor
    ssm: torch.Tensor


def init_ssm_cache(batch: int, d_model: int, cfg: SSMConfig,
                   dtype=torch.bfloat16, *, device=None) -> SSMCache:
    di = cfg.d_inner(d_model)
    h = cfg.n_ssm_heads(d_model)
    return SSMCache(
        conv=torch.zeros(batch, cfg.d_conv - 1, di + 2 * cfg.d_state,
                         dtype=dtype, device=device),
        ssm=torch.zeros(batch, h, cfg.headdim, cfg.d_state, dtype=dtype,
                        device=device))


def mamba2_decode(p: Mamba2, x: torch.Tensor, cache: SSMCache, d_model: int,
                  cfg: SSMConfig, *, norm_eps: float = 1e-6):
    """One-token step.  x: [B, 1, D].  Returns (y [B, 1, D], cache).

    As :func:`~repro_torch.models.attention.attn_decode` does, the new
    state is written into ``cache`` in place (rounded to its dtype, as the
    reference rounds its new cache) and the same cache is returned; ``y``
    reads the state before that rounding, as the reference's does."""
    di = cfg.d_inner(d_model)
    n = cfg.d_state
    h = cfg.n_ssm_heads(d_model)

    u = dense(p.in_proj, x)
    z, xbc, dt = _split_proj(u, di, n, h)
    # conv over (K-1 cached taps + this token)
    xp = torch.cat([cache.conv.to(x.dtype), xbc], dim=1)
    k = p.conv_w.shape[0]
    conv_out = sum(xp[:, i: i + 1] * per_channel(p.conv_w[i].to(x.dtype), xp)
                   for i in range(k)) + per_channel(p.conv_b.to(x.dtype), xp)
    xbc1 = F.silu(conv_out)                               # [B, 1, C]
    xc = xbc1[..., :di]
    B = xbc1[..., di: di + n][:, 0]                       # [B, N]
    C = xbc1[..., di + n:][:, 0]

    dt1 = softplus(dt.float()
                   + per_channel(p.dt_bias.float(), dt))[:, 0]  # [B, H]
    a_head = -torch.exp(p.A_log.float())
    dec = torch.exp(dt1 * a_head)                         # [B, H]
    xh = xc.reshape(x.shape[0], h, cfg.headdim).float()
    upd = torch.einsum("bh,bn,bhp->bhpn", dt1, B.float(), xh)
    ssm = dec[:, :, None, None] * cache.ssm.float() + upd
    y = torch.einsum("bn,bhpn->bhp", C.float(), ssm)
    y = y + per_channel(p.D.float(), xh, 1)[:, None] * xh
    y = y.reshape(x.shape[0], 1, di).to(x.dtype)
    y = rmsnorm(p.norm, y, norm_eps) * F.silu(z)
    out = dense(p.out_proj, y)
    cache.conv.copy_(as_layout(xp[:, -(k - 1):], cache.conv))
    cache.ssm.copy_(as_layout(ssm, cache.ssm))
    return out, cache
