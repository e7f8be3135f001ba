"""Decoder-only LM — the port of :mod:`repro.models.transformer` (dense /
GQA / SWA / local:global / MoE / VLM).

The reference stacks its layers on a leading ``L`` axis and runs them with
``lax.scan``; here the layers are an ``nn.ModuleList`` walked by a Python
loop, and the per-layer window (gemma3's 5 local : 1 global pattern) is a
static tuple read per layer.  :mod:`repro_torch.convert` splits the
reference's stacked parameters into the list.

Entry points: :func:`init_params`, :func:`forward` (train/prefill),
:func:`init_cache` and :func:`decode_step`.  :func:`forward` checkpoints
each block (``torch.utils.checkpoint``, non-reentrant) when ``cfg.remat``
asks and a gradient is being taken, as the reference wraps its scan body
in ``jax.checkpoint``; serving, which takes none, runs the blocks plain.
A MoE config's blocks hold :class:`~repro_torch.models.moe.MoE` in place
of the MLP (:func:`~repro_torch.models.moe.moe_ffn` at their FFN site).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.hints import DATA, MODEL, hint, remat_context
from repro_torch.models.attention import (Attention, AttnCache, attention,
                                          attn_decode)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, Embedding, MLPGelu,
                                       draw_parameters, embed, ffn,
                                       make_norm, norm, unembed)
from repro_torch.models.moe import MoE, moe_ffn

__all__ = ["Transformer", "Block", "init_params", "forward", "init_cache",
           "decode_step", "layer_windows", "FULL_WINDOW", "dtype_of"]

#: "no window" sentinel large enough for any assigned context (≤ 2^20).
FULL_WINDOW = 1 << 24


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype a config names (``"bfloat16"``, ``"float32"``)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def layer_windows(cfg: ModelConfig) -> Optional[tuple]:
    """Per-layer attention window (static tuple[int]) or None for pure
    full attention."""
    if cfg.local_global_ratio > 0:
        period = cfg.local_global_ratio + 1
        return tuple(cfg.sliding_window or 1024 if (l + 1) % period
                     else FULL_WINDOW for l in range(cfg.n_layers))
    if cfg.sliding_window is not None:
        return (cfg.sliding_window,) * cfg.n_layers
    return None


class Block(nn.Module):
    """Pre-norm block: ``h = x + attn(ln1 x)``; ``h + ffn(ln2 h)``, the FFN
    ``moe`` for a MoE config, else ``mlp``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.ln1 = make_norm(cfg.d_model, cfg.norm_kind, device=device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, bias=cfg.qkv_bias, device=device)
        self.ln2 = make_norm(cfg.d_model, cfg.norm_kind, device=device)
        if cfg.moe is not None:
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.moe, device=device)
        else:
            self.mlp = (MLPGelu if cfg.mlp_kind == "gelu" else MLP)(
                cfg.d_model, cfg.d_ff, device=device)


def _ffn(lp: Block, z, cfg: ModelConfig):
    return moe_ffn(lp.moe, z, cfg.moe) if cfg.moe is not None \
        else ffn(lp.mlp, z)


class Transformer(nn.Module):
    """The LM's parameters: ``embed`` (tied), ``layers`` and ``ln_f`` —
    the reference's pytree keys.  Allocated, not drawn: see
    :func:`init_params`."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab, cfg.d_model, device=device)
        self.layers = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = make_norm(cfg.d_model, cfg.norm_kind, device=device)

    def forward(self, tokens: torch.Tensor,
                extra_embeds: Optional[torch.Tensor] = None,
                last_only: bool = False) -> torch.Tensor:
        """:func:`forward` with this module's config, so that
        ``torch.func.functional_call`` can run the model on other tensors
        (the GGN operator, :mod:`repro_torch.core.gn`).  Always without
        remat: ``functional_call`` puts the module's own tensors back
        before a checkpoint's backward would recompute the block, and the
        ``torch.func`` transforms refuse the saved-tensor hooks
        non-reentrant checkpointing uses.  Remat changes memory, not
        arithmetic."""
        return _forward(self, self.cfg, tokens, extra_embeds, last_only,
                        remat=False)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> Transformer:
    """Random parameters on ``device`` (default ``cuda``), drawn from
    ``generator`` (default: seed 0 on that device) with the reference's
    truncated normal and scales.  The values differ from the reference's
    ``jax.random`` draws; to compare the two packages, carry the JAX
    parameters across with :func:`repro_torch.convert.lm_params_to_torch`."""
    dev = resolve_device(device)
    return draw_parameters(Transformer(cfg, device=dev), generator)


def _block(lp: Block, x, cfg: ModelConfig, *, positions, window):
    # sequence parallelism: the residual stream is seq-sharded on `model`
    # at block boundaries; the attention/FFN input is re-gathered to
    # seq-replicated, so the activation moves and not the weight
    x = hint(x, DATA, MODEL, None)
    u = hint(norm(lp.ln1, x, cfg.norm_eps), DATA, None, None)
    h = x + hint(attention(lp.attn, u, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                           positions=positions, window=window, causal=True,
                           rope_theta=cfg.rope_theta), DATA, MODEL, None)
    z = hint(norm(lp.ln2, h, cfg.norm_eps), DATA, None, None)
    return h + hint(_ffn(lp, z, cfg), DATA, MODEL, None)


def forward(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None,
            last_only: bool = False) -> torch.Tensor:
    """tokens [B, S] (+ optional prepended embeddings [B, P, D]) -> logits
    over the token positions only: [B, S, vocab] (fp32).  ``last_only``
    returns [B, 1, vocab]: serving prefill never materializes the
    full-sequence logits.  Each block is checkpointed when ``cfg.remat``
    and a gradient is being taken (grad mode on and a parameter that
    requires one)."""
    remat = cfg.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in params.parameters())
    return _forward(params, cfg, tokens, extra_embeds, last_only, remat)


def _forward(params: Transformer, cfg: ModelConfig, tokens, extra_embeds,
             last_only: bool, remat: bool) -> torch.Tensor:
    dt = dtype_of(cfg.dtype)
    x = embed(params.embed, tokens, dt)
    n_prefix = 0
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(dt), x], dim=1)
        n_prefix = extra_embeds.shape[1]
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    windows = layer_windows(cfg)
    for l, lp in enumerate(params.layers):
        kw = dict(positions=positions,
                  window=None if windows is None else windows[l])
        x = checkpoint(_block, lp, x, cfg, use_reentrant=False,
                       context_fn=remat_context(), **kw) \
            if remat else _block(lp, x, cfg, **kw)
    # the unembedding's input is re-gathered to seq-replicated, as a
    # block's is (a matmul over batch and seq both sharded would
    # flatten two sharded dims)
    x = hint(norm(params.ln_f, x, cfg.norm_eps), DATA, None, None)
    if last_only:
        x = x[:, -1:]
    elif n_prefix:
        x = x[:, n_prefix:]
    return unembed(params.embed, x)


# ------------------------------------------------------------------ decode
def _stacked_cache(n_layers: int, batch: int, length: int, kv: int, hd: int,
                   ring: bool, dtype, device) -> AttnCache:
    shape = (n_layers, batch, kv, length, hd)     # head-major (attention.py)
    return AttnCache(torch.zeros(shape, dtype=dtype, device=device),
                     torch.zeros(shape, dtype=dtype, device=device), ring)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> Dict[str, AttnCache]:
    """Stacked per-layer KV caches, as the reference lays them out.
    Windowed layers get ring buffers of the window length; gemma3's mixed
    ring/full stack is split into two stacks (``"ring"``, ``"full"``) to
    stay rectangular."""
    dev = resolve_device(device)
    windows = layer_windows(cfg)
    if windows is None:
        return {"full": _stacked_cache(cfg.n_layers, batch, max_len,
                                       cfg.n_kv_heads, cfg.hd, False, dtype,
                                       dev)}
    w = [int(v) for v in windows]
    ring_len = min(min([v for v in w if v < FULL_WINDOW], default=max_len),
                   max_len)
    n_ring = sum(1 for v in w if v < FULL_WINDOW)
    n_full = cfg.n_layers - n_ring
    caches = {}
    if n_ring:
        caches["ring"] = _stacked_cache(n_ring, batch, ring_len,
                                        cfg.n_kv_heads, cfg.hd, True, dtype,
                                        dev)
    if n_full:
        caches["full"] = _stacked_cache(n_full, batch, max_len,
                                        cfg.n_kv_heads, cfg.hd, False, dtype,
                                        dev)
    return caches


def _layer_caches(cfg: ModelConfig, cache: Dict[str, AttnCache]):
    """Per layer: (its cache — views into the stacks —, its decode window).

    One rule covers the reference's three branches: pure full attention
    (every layer in ``"full"``, no window), uniform SWA (every layer in
    ``"ring"``) and mixed local:global (ring layers in order in ``"ring"``,
    global layers in ``"full"`` with no window)."""
    windows = layer_windows(cfg)
    seen = {"ring": 0, "full": 0}
    out = []
    for l in range(cfg.n_layers):
        w = None if windows is None else int(windows[l])
        name = "ring" if w is not None and w < FULL_WINDOW else "full"
        stack = cache[name]
        i = seen[name]
        seen[name] += 1
        out.append((AttnCache(stack.k[i], stack.v[i], stack.ring),
                    w if name == "ring" else None))
    return out


def decode_step(params: Transformer, cfg: ModelConfig,
                cache: Dict[str, AttnCache], token: torch.Tensor, pos):
    """One decode step.  token [B] int; pos an int or an int tensor of
    shape () or [B].  Returns (logits [B, vocab] fp32, cache), the cache
    updated in place (see :func:`~repro_torch.models.attention.attn_decode`)."""
    dt = dtype_of(cfg.dtype)
    h = embed(params.embed, token[:, None], dt)     # [B, 1, D]
    pos = torch.as_tensor(pos, device=h.device)     # once, not per layer
    for lp, (c, win) in zip(params.layers, _layer_caches(cfg, cache)):
        y, _ = attn_decode(lp.attn, norm(lp.ln1, h, cfg.norm_eps), c, pos,
                           n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                           head_dim=cfg.hd, window=win,
                           rope_theta=cfg.rope_theta)
        h = h + y
        z = norm(lp.ln2, h, cfg.norm_eps)
        h = h + _ffn(lp, z, cfg)
    h = norm(params.ln_f, h, cfg.norm_eps)
    return unembed(params.embed, h)[:, 0], cache
