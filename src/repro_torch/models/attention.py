"""Attention — the port of :mod:`repro.models.attention`: GQA/MQA,
sliding-window and local:global masks, cross attention, and KV-cache
decode.

* **GQA/MQA** — ``n_kv_heads`` ≤ ``n_heads``.  The full-sequence path
  repeats the kv heads (``_repeat_kv``); the decode path groups the query
  heads per kv head instead, so the cache is never repeated.
* **Sliding window** (h2o-danube, gemma3 local layers) — the mask keeps
  ``(i − w, i]``; decode uses a **ring KV cache** of length ``w``.
* **Cross attention** (whisper's decoder, and its bidirectional encoder
  as cross attention of a sequence on itself) — ``cross_kv``: k and v
  from the encoder states, no mask, no RoPE.  Decode attends to the
  cached encoder K/V through the seq-major grouped helpers
  (:func:`_gqa_scores_grouped`, :func:`_gqa_out_grouped`).
* Softmax statistics are fp32 whatever the compute dtype; masked scores
  are ``_NEG = −1e30``.

Long sequences (S ≥ :data:`CHUNKED_ABOVE`) run query chunk by query chunk
(the reference's ``lax.scan`` over Q blocks is a Python loop here), so the
``[chunk, T]`` score tile, not ``[S, T]``, is the peak live tensor.

The computation is plain PyTorch, as the reference's is plain ``jnp``: the
hand-written kernel :func:`repro_torch.kernels.flash_attention` is an entry
point of its own, held against this module on the model's own q/k/v.  The
reference's sharding hints (``distributed.hints``) are no-ops without a
mesh and are left out.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.models.layers import Dense, apply_rope, dense, rope_freqs

__all__ = ["Attention", "attention", "AttnCache", "init_attn_cache",
           "attn_decode", "CHUNKED_ABOVE", "Q_CHUNK"]

_NEG = -1e30

#: sequences at or above this length use the Q-chunked path.
CHUNKED_ABOVE = 8192
Q_CHUNK = 1024


class Attention(nn.Module):
    """Projections ``wq [d, H·hd]``, ``wk``/``wv [d, Hk·hd]`` (with a bias
    for qwen2.5) and ``wo [H·hd, d]``."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 head_dim: int, *, bias: bool = False, device=None):
        super().__init__()
        self.wq = Dense(d_model, n_heads * head_dim, bias=bias, device=device)
        self.wk = Dense(d_model, n_kv_heads * head_dim, bias=bias,
                        device=device)
        self.wv = Dense(d_model, n_kv_heads * head_dim, bias=bias,
                        device=device)
        self.wo = Dense(n_heads * head_dim, d_model, device=device)


def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, d)


def _repeat_kv(kv: torch.Tensor, hq: int) -> torch.Tensor:
    """GQA via head repetition: [B,T,Hk,D] -> [B,T,Hq,D] (each kv head
    repeated in place, as ``jnp.repeat``)."""
    hk = kv.shape[2]
    if hk == hq:
        return kv
    return torch.repeat_interleave(kv, hq // hk, dim=2)


def _gqa_scores_grouped(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Decode-path GQA on a seq-major cache: q [B,S,Hq,D] × k [B,T,Hk,D]
    -> [B,Hq,S,T], query heads grouped per kv head (no kv repetition)."""
    b, s, hq, dd = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, s, hk, hq // hk, dd)
    sc = torch.einsum("bshgd,bthd->bhgst", qg, k)
    return sc.reshape(b, hq, s, k.shape[1])


def _gqa_out_grouped(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w [B,Hq,S,T] × seq-major v [B,T,Hk,D] -> [B,S,Hq,D]."""
    b, hq, s, t = w.shape
    hk = v.shape[2]
    wg = w.reshape(b, hk, hq // hk, s, t)
    o = torch.einsum("bhgst,bthd->bshgd", wg, v)
    return o.reshape(b, s, hq, v.shape[-1])


def _pick_chunk(s: int, target: int) -> Optional[int]:
    """Largest divisor of ``s`` that is ≤ target and a multiple of 8."""
    for c in range(min(target, s), 7, -1):
        if s % c == 0 and c % 8 == 0:
            return c
    return None


def _masked_softmax_attn(q, k, v, positions_q, positions_k, *, causal,
                         window, head_dim, compute_dtype):
    """scores -> mask -> softmax -> out for one q block (fp32 softmax).
    q [B,S,H,D], k/v [B,T,H,D] (kv heads already repeated) -> [B,S,H,D]."""
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() \
        * (head_dim ** -0.5)
    if causal or window is not None:
        i = positions_q[:, :, None]                  # [B|1, Sq, 1]
        j = positions_k[:, None, :]                  # [B|1, 1, T]
        mask = torch.ones(torch.broadcast_shapes(i.shape, j.shape),
                          dtype=torch.bool, device=q.device)
        if causal:
            mask &= j <= i
        if window is not None:
            mask &= j > i - window
        scores = torch.where(mask[:, None], scores, _NEG)
    w = torch.softmax(scores, dim=-1).to(compute_dtype)
    return torch.einsum("bhst,bthd->bshd", w, v)


def attention(p: Attention, x: torch.Tensor, *, n_heads: int,
              n_kv_heads: int, head_dim: int,
              positions: Optional[torch.Tensor] = None,
              window: Optional[int] = None, causal: bool = True,
              rope_theta: float = 10_000.0,
              cross_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention.  x: [B, S, D] -> [B, S, D].
    ``window``: sliding-window width (None = full).  ``cross_kv``
    [B, T, D] switches to cross attention: k and v projected from it, no
    RoPE, no mask (``causal`` and ``window`` are ignored)."""
    b, s, _ = x.shape
    q = _split_heads(dense(p.wq, x), n_heads, head_dim)
    kv_src = x if cross_kv is None else cross_kv
    k = _split_heads(dense(p.wk, kv_src), n_kv_heads, head_dim)
    v = _split_heads(dense(p.wv, kv_src), n_kv_heads, head_dim)
    if cross_kv is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        cos, sin = rope_freqs(positions, head_dim, rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        pos_k = positions
    else:
        positions = torch.arange(s, device=x.device)[None, :]
        pos_k = torch.arange(k.shape[1], device=x.device)[None, :]
        causal, window = False, None
    k = _repeat_kv(k, n_heads)                      # once, not per chunk
    v = _repeat_kv(v, n_heads)

    kw = dict(causal=causal, window=window, head_dim=head_dim,
              compute_dtype=x.dtype)
    chunk = _pick_chunk(s, Q_CHUNK) if s >= CHUNKED_ABOVE else None
    if chunk is not None and positions.shape[0] == 1:
        o = torch.cat([
            _masked_softmax_attn(q[:, c:c + chunk], k, v,
                                 positions[:, c:c + chunk], pos_k, **kw)
            for c in range(0, s, chunk)], dim=1)
    else:
        o = _masked_softmax_attn(q, k, v, positions, pos_k, **kw)
    return dense(p.wo, o.reshape(b, s, n_heads * head_dim))


# ------------------------------------------------------------------ decode
@dataclasses.dataclass
class AttnCache:
    """KV cache for one attention layer (or a stack of layers, on a leading
    axis), stored HEAD-MAJOR as in the reference.

    Full-context layers: ``k/v [B, Hk, S_max, D]``, slot = position.
    Windowed layers: ``k/v [B, Hk, w, D]`` ring buffer, slot = pos mod w.
    """
    k: torch.Tensor
    v: torch.Tensor
    ring: bool


def init_attn_cache(batch: int, length: int, n_kv_heads: int, head_dim: int,
                    *, ring: bool = False, dtype=torch.bfloat16,
                    device=None) -> AttnCache:
    shape = (batch, n_kv_heads, length, head_dim)
    return AttnCache(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device), ring)


def _scores_headmajor(q: torch.Tensor, kT: torch.Tensor) -> torch.Tensor:
    """q [B,1,Hq,D] × head-major cache kT [B,Hk,T,D] -> [B,Hq,1,T], query
    heads grouped per kv head (no kv repetition)."""
    b, s, hq, dd = q.shape
    hk = kT.shape[1]
    qg = q.reshape(b, s, hk, hq // hk, dd)
    sc = torch.einsum("bshgd,bhtd->bhgst", qg, kT)
    return sc.reshape(b, hq, s, kT.shape[2])


def _out_headmajor(w: torch.Tensor, vT: torch.Tensor) -> torch.Tensor:
    """w [B,Hq,1,T] × head-major vT [B,Hk,T,D] -> [B,1,Hq,D]."""
    b, hq, s, t = w.shape
    hk = vT.shape[1]
    wg = w.reshape(b, hk, hq // hk, s, t)
    o = torch.einsum("bhgst,bhtd->bshgd", wg, vT)
    return o.reshape(b, s, hq, vT.shape[-1])


def attn_decode(p: Attention, x: torch.Tensor, cache: AttnCache,
                pos, *, n_heads: int, n_kv_heads: int, head_dim: int,
                window: Optional[int] = None,
                rope_theta: float = 10_000.0):
    """One-token decode.  x: [B, 1, D]; pos: an int or an int tensor of
    shape () or [B] (tokens so far per request slot — ragged batching).

    Returns (y [B, 1, D], cache).  Unlike the reference, which returns a
    new cache, the new k/v rows are written into ``cache`` in place (and
    the same cache is returned): a copy of every layer's cache per token
    would cost more than the token itself.
    """
    b = x.shape[0]
    length = cache.k.shape[2]
    q = _split_heads(dense(p.wq, x), n_heads, head_dim)
    k = _split_heads(dense(p.wk, x), n_kv_heads, head_dim)
    v = _split_heads(dense(p.wv, x), n_kv_heads, head_dim)

    pos = torch.as_tensor(pos, device=x.device).to(torch.int64).expand(b)
    cos, sin = rope_freqs(pos[:, None], head_dim, rope_theta)   # [B,1,half]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    slot = pos % length if cache.ring else pos                  # [B]
    bidx = torch.arange(b, device=x.device)[:, None]            # [B,1]
    hidx = torch.arange(n_kv_heads, device=x.device)[None, :]   # [1,Hk]
    cache.k[bidx, hidx, slot[:, None]] = k[:, 0].to(cache.k.dtype)
    cache.v[bidx, hidx, slot[:, None]] = v[:, 0].to(cache.v.dtype)

    scores = _scores_headmajor(q, cache.k.to(x.dtype)).float() \
        * (head_dim ** -0.5)                        # [B, Hq, 1, L]
    j = torch.arange(length, device=x.device)[None, :]          # [1, L]
    pb = pos[:, None]
    if cache.ring:
        # Ring of length w: slot s holds the most recent position ≡ s
        # (mod w), which is always within the window once written.  Before
        # the first wrap only slots ≤ pos are written.
        valid = (pb >= length) | (j <= pb)
    else:
        valid = j <= pb
        if window is not None:
            valid &= j > pb - window
    scores = torch.where(valid[:, None, None, :], scores, _NEG)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o = _out_headmajor(w, cache.v.to(x.dtype))
    y = dense(p.wo, o.reshape(b, 1, n_heads * head_dim))
    return y, cache
