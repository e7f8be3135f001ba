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
full-sequence path hints q, k and v heads-on-``model`` as the reference
does (:mod:`repro_torch.distributed.hints`; no-ops without a mesh).

On DTensors (the sharded train step, the dry run) DTensor's own rules
cannot place every op here, and these routes take their place, each a
no-op without a mesh:

* ``hints.split_ready`` before each split of a feature dim into heads
  (and of heads into kv groups): a dim sharded over more shards than
  there are heads is gathered first;
* ``hints.pin`` after the merge of heads into features, so the backward's
  split meets the forward's layout;
* ``local_map`` for the scores, mask, softmax and output: batch and
  heads are independent, so each rank attends its own shard (the einsums
  would flatten two sharded dims, which torch 2.11 refuses);
* :func:`_write_slots` for the decode cache's in-place row write (no
  DTensor rule for an in-place ``index_put_`` on a sharded cache).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.distributed.hints import (DATA, MODEL, hint, is_dtensor,
                                           local_like, local_offset, pin,
                                           split_ready)
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
    return split_ready(x, -1, n).reshape(*x.shape[:-1], n, d)


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
    qg = split_ready(q, 2, hk).reshape(b, s, hk, hq // hk, dd)
    sc = torch.einsum("bshgd,bthd->bhgst", qg, k)
    return sc.reshape(b, hq, s, k.shape[1])


def _gqa_out_grouped(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w [B,Hq,S,T] × seq-major v [B,T,Hk,D] -> [B,S,Hq,D]."""
    b, hq, s, t = w.shape
    hk = v.shape[2]
    wg = split_ready(w, 1, hk).reshape(b, hk, hq // hk, s, t)
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
    q = hint(q, DATA, None, MODEL, None)
    # batch stays on DATA: a bare None would gather the global K
    k = hint(_repeat_kv(k, n_heads), DATA, None, MODEL, None)  # once,
    v = hint(_repeat_kv(v, n_heads), DATA, None, MODEL, None)  # not a chunk

    kw = dict(causal=causal, window=window, head_dim=head_dim,
              compute_dtype=x.dtype)
    if is_dtensor(q):
        # batch and heads are independent: each rank attends its shard
        from torch.distributed.tensor.experimental import local_map
        if positions.shape[0] > 1:
            b0 = local_offset(q, 0)
            positions = positions[b0:b0 + q.to_local().shape[0]]
        pl = list(q.placements)
        o = local_map(lambda *qkv: _attend(*qkv, positions, pos_k, kw),
                      out_placements=pl, in_placements=(pl, pl, pl),
                      redistribute_inputs=True)(q, k, v)
    else:
        o = _attend(q, k, v, positions, pos_k, kw)
    return dense(p.wo, pin(o.reshape(b, s, n_heads * head_dim)))


def _attend(q, k, v, positions, pos_k, kw):
    """The scores, mask, softmax and output of every query, query chunk by
    query chunk for a long sequence."""
    s = q.shape[1]
    chunk = _pick_chunk(s, Q_CHUNK) if s >= CHUNKED_ABOVE else None
    if chunk is not None and positions.shape[0] == 1:
        return torch.cat([
            _masked_softmax_attn(q[:, c:c + chunk], k, v,
                                 positions[:, c:c + chunk], pos_k, **kw)
            for c in range(0, s, chunk)], dim=1)
    return _masked_softmax_attn(q, k, v, positions, pos_k, **kw)


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
    qg = split_ready(q, 2, hk).reshape(b, s, hk, hq // hk, dd)
    sc = torch.einsum("bshgd,bhtd->bhgst", qg, kT)
    return sc.reshape(b, hq, s, kT.shape[2])


def _out_headmajor(w: torch.Tensor, vT: torch.Tensor) -> torch.Tensor:
    """w [B,Hq,1,T] × head-major vT [B,Hk,T,D] -> [B,1,Hq,D]."""
    b, hq, s, t = w.shape
    hk = vT.shape[1]
    wg = split_ready(w, 1, hk).reshape(b, hk, hq // hk, s, t)
    o = torch.einsum("bhgst,bhtd->bshgd", wg, vT)
    return o.reshape(b, s, hq, vT.shape[-1])


def _write_slots(c: torch.Tensor, new: torch.Tensor, slot: torch.Tensor):
    """``c[b, :, slot[b]] = new[b]`` for every row b, in place (``c`` a
    head-major cache [B, Hk, L, D], ``new`` [B, Hk, D], ``slot`` [B]).

    A DTensor cache (batch on ``data``, length on ``model``: DTensor has no
    rule for an in-place ``index_put_`` on it) is written shard by shard:
    ``new`` laid out as the cache's batch and heads, each rank writes the
    rows whose slot falls in its block of the length and writes back what
    it holds elsewhere."""
    b, hk = c.shape[0], c.shape[1]
    if not is_dtensor(c):
        bidx = torch.arange(b, device=c.device)[:, None]        # [B,1]
        hidx = torch.arange(hk, device=c.device)[None, :]       # [1,Hk]
        c[bidx, hidx, slot[:, None]] = new.to(c.dtype)
        return
    loc = c.to_local()
    new = local_like(new, c, {0: 0, 1: 1}).to(loc.dtype)
    b0, l0 = local_offset(c, 0), local_offset(c, 2)
    if is_dtensor(slot):
        slot = slot.full_tensor()
    s = slot.expand(b)[b0:b0 + loc.shape[0]] - l0
    inside = (s >= 0) & (s < loc.shape[2])
    s = s.clamp(0, loc.shape[2] - 1)
    bidx = torch.arange(loc.shape[0], device=loc.device)[:, None]
    hidx = torch.arange(loc.shape[1], device=loc.device)[None, :]
    cur = loc[bidx, hidx, s[:, None]]
    loc[bidx, hidx, s[:, None]] = torch.where(inside[:, None, None], new, cur)


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
    _write_slots(cache.k, k[:, 0], slot)
    _write_slots(cache.v, v[:, 0], slot)

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
