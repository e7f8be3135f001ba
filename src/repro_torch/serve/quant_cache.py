"""Int8-quantized KV cache — the port of :mod:`repro.serve.quant_cache`:
the paper's Mix-V3 principle one tier further down the serving stack.

Callipepla stores the streamed operand (the sparse matrix) one precision
tier below the iterate and casts it in registers.  Decode is the same
regime: the KV cache is the streamed operand, the query and the output
the iterate.  So K/V are stored **int8 with one fp32 scale per (batch,
head, position)** (row-wise absmax), dequantized at the score and output
einsums, with q and the softmax at fp32.  Cache bytes are about half of
bf16's (int8 payload plus the scales).

:func:`quantize_kv` gives the reference's int8 values and scales bit for
bit (``torch.round`` rounds half to even, as ``jnp.round`` does).
:func:`attn_decode_quant` has :func:`~repro_torch.models.attention
.attn_decode`'s contract and, like it, writes the new row into the cache
in place.  As in the reference, no engine uses this cache yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import _NEG, Attention, _split_heads
from repro_torch.models.layers import apply_rope, dense, rope_freqs

__all__ = ["QuantAttnCache", "init_quant_cache", "attn_decode_quant",
           "quantize_kv", "dequantize_kv"]


@dataclasses.dataclass
class QuantAttnCache:
    """Head-major int8 KV cache: values [B, Hk, T, D] int8 and one fp32
    scale per (b, h, t).  ``ring`` as in ``AttnCache``."""
    k: torch.Tensor            # int8 [B, Hk, T, D]
    v: torch.Tensor            # int8 [B, Hk, T, D]
    k_scale: torch.Tensor      # fp32 [B, Hk, T]
    v_scale: torch.Tensor      # fp32 [B, Hk, T]
    ring: bool


def init_quant_cache(batch: int, length: int, n_kv_heads: int,
                     head_dim: int, *, ring: bool = False,
                     device=None) -> QuantAttnCache:
    """A zero cache on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    shape = (batch, n_kv_heads, length, head_dim)
    return QuantAttnCache(
        k=torch.zeros(shape, dtype=torch.int8, device=device),
        v=torch.zeros(shape, dtype=torch.int8, device=device),
        k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
        v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
        ring=ring)


def quantize_kv(x: torch.Tensor):
    """x [..., D] -> (int8 values, fp32 scale over the last dim)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def attn_decode_quant(p: Attention, x: torch.Tensor, cache: QuantAttnCache,
                      pos, *, n_heads: int, n_kv_heads: int, head_dim: int,
                      window: Optional[int] = None,
                      rope_theta: float = 10_000.0):
    """One-token decode against the int8 cache: x [B, 1, D]; pos an int or
    an int tensor of shape () or [B].  Returns (y [B, 1, D], cache), the
    new quantized row and its scales written into ``cache`` in place."""
    b = x.shape[0]
    length = cache.k.shape[2]
    q = _split_heads(dense(p.wq, x), n_heads, head_dim)
    k = _split_heads(dense(p.wk, x), n_kv_heads, head_dim)
    v = _split_heads(dense(p.wv, x), n_kv_heads, head_dim)

    pos = torch.as_tensor(pos, device=x.device).to(torch.int64).expand(b)
    cos, sin = rope_freqs(pos[:, None], head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    slot = pos % length if cache.ring else pos
    bidx = torch.arange(b, device=x.device)[:, None]
    hidx = torch.arange(n_kv_heads, device=x.device)[None, :]
    kq, ks = quantize_kv(k[:, 0])              # [B,Hk,D] int8, [B,Hk] fp32
    vq, vs = quantize_kv(v[:, 0])
    cache.k[bidx, hidx, slot[:, None]] = kq
    cache.v[bidx, hidx, slot[:, None]] = vq
    cache.k_scale[bidx, hidx, slot[:, None]] = ks
    cache.v_scale[bidx, hidx, slot[:, None]] = vs

    # scores: (q · k_i8) * scale_i — the scale factors out of the dot, so
    # the int8 payload is the only per-position stream
    g = n_heads // n_kv_heads
    qg = q.reshape(b, 1, n_kv_heads, g, head_dim).float()
    sc = torch.einsum("bshgd,bhtd->bhgst", qg, cache.k.float())
    sc = sc * cache.k_scale[:, :, None, None, :]          # [B,Hk,g,1,T]
    scores = sc.reshape(b, n_heads, 1, length) * (head_dim ** -0.5)

    j = torch.arange(length, device=x.device)[None, :]
    pb = pos[:, None]
    if cache.ring:
        valid = (pb >= length) | (j <= pb)
    else:
        valid = j <= pb
        if window is not None:
            valid &= j > pb - window
    scores = torch.where(valid[:, None, None, :], scores, _NEG)
    w = torch.softmax(scores, dim=-1)                     # fp32

    wg = w.reshape(b, n_kv_heads, g, 1, length)
    wv = wg * cache.v_scale[:, :, None, None, :]          # fold scale into w
    o = torch.einsum("bhgst,bhtd->bshgd", wv, cache.v.float())
    o = o.reshape(b, 1, n_heads * head_dim).to(x.dtype)
    return dense(p.wo, o), cache
