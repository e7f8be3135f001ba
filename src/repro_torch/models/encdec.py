"""Encoder-decoder LM (whisper-base's backbone) — the port of
:mod:`repro.models.encdec`; the conv frontend is a stub.

As in the reference, the model takes precomputed frame embeddings
``audio_embeds [B, n_ctx, d_model]`` (the conv1d×2 + GELU frontend's
output), so the encoder is the bidirectional stack over them with
whisper's sinusoidal positions.  The decoder is causal self attention
(RoPE in place of whisper's learned 448-position table, as the reference
has it), cross attention to the encoder states, and a GELU MLP.  Whisper's
flavor: LayerNorm, GELU MLP, q/k/v biases on every attention whatever
``cfg.qkv_bias`` says.

The reference stacks each stack's layers and scans them; here they are
two ``nn.ModuleList``s (``enc_layers``, ``dec_layers``) walked by Python
loops, each layer body checkpointed when ``cfg.remat`` asks and a gradient
is taken.  The decoder block's input is hinted seq-sharded, as the
reference's is (:mod:`repro_torch.distributed.hints`; a no-op without a
mesh).

Decode: :func:`init_cache` holds the decoder's self-attention cache (one
stacked :class:`~repro_torch.models.attention.AttnCache`, head-major) and
the cross K/V as bare seq-major tensors ``[L, B, n_ctx, Hk, hd]``, which
:func:`prefill_cross` fills once per request from the encoder states.
:func:`decode_step` writes the self cache in place, as
:func:`~repro_torch.models.attention.attn_decode` does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.hints import DATA, MODEL, hint, remat_context
from repro_torch.models.attention import (Attention, AttnCache,
                                          _gqa_out_grouped,
                                          _gqa_scores_grouped, _split_heads,
                                          attention, attn_decode)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Embedding, MLPGelu, dense,
                                       draw_parameters, embed, ffn,
                                       make_norm, norm, unembed)
from repro_torch.models.transformer import dtype_of

__all__ = ["EncDec", "init_params", "forward", "encode", "init_cache",
           "prefill_cross", "decode_step"]


def _sinusoids(length: int, d: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal position embeddings [length, d], fp32
    throughout as the reference's."""
    half = d // 2
    f32 = dict(dtype=torch.float32, device=device)
    log_ts = torch.log(torch.tensor(10_000.0, **f32)) / (half - 1)
    inv = torch.exp(-log_ts * torch.arange(half, **f32))
    ang = torch.arange(length, **f32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def _attn(cfg: ModelConfig, device) -> Attention:
    return Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                     bias=True, device=device)


class EncLayer(nn.Module):
    """``ln1``, ``attn`` (bidirectional), ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.ln1 = make_norm(cfg.d_model, cfg.norm_kind, device=device)
        self.attn = _attn(cfg, device)
        self.ln2 = make_norm(cfg.d_model, cfg.norm_kind, device=device)
        self.mlp = MLPGelu(cfg.d_model, cfg.d_ff, device=device)


class DecLayer(nn.Module):
    """``ln1``, ``attn`` (causal), ``lnx``, ``xattn`` (cross), ``ln2``,
    ``mlp``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.ln1 = make_norm(cfg.d_model, cfg.norm_kind, device=device)
        self.attn = _attn(cfg, device)
        self.lnx = make_norm(cfg.d_model, cfg.norm_kind, device=device)
        self.xattn = _attn(cfg, device)
        self.ln2 = make_norm(cfg.d_model, cfg.norm_kind, device=device)
        self.mlp = MLPGelu(cfg.d_model, cfg.d_ff, device=device)


class EncDec(nn.Module):
    """The LM's parameters: ``embed`` (tied), ``enc_layers``, ``enc_ln``,
    ``dec_layers`` and ``ln_f`` — the reference's pytree keys.  Allocated,
    not drawn: see :func:`init_params`."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab, cfg.d_model, device=device)
        self.enc_layers = nn.ModuleList(EncLayer(cfg, device=device)
                                        for _ in range(cfg.encoder.n_layers))
        self.enc_ln = make_norm(cfg.d_model, cfg.norm_kind, device=device)
        self.dec_layers = nn.ModuleList(DecLayer(cfg, device=device)
                                        for _ in range(cfg.n_layers))
        self.ln_f = make_norm(cfg.d_model, cfg.norm_kind, device=device)

    def forward(self, tokens: torch.Tensor, audio_embeds: torch.Tensor,
                last_only: bool = False) -> torch.Tensor:
        """:func:`forward` with this module's config, always without remat,
        for ``torch.func.functional_call`` (see
        :meth:`repro_torch.models.transformer.Transformer.forward`)."""
        return _forward(self, self.cfg, tokens, audio_embeds, last_only,
                        remat=False)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> EncDec:
    """Random parameters on ``device`` (default ``cuda``), drawn from
    ``generator`` with the reference's truncated normal and scales (the
    values differ from the reference's ``jax.random`` draws)."""
    dev = resolve_device(device)
    return draw_parameters(EncDec(cfg, device=dev), generator)


def _wants_remat(params: EncDec, cfg: ModelConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in params.parameters())


def _enc_block(lp: EncLayer, h, cfg: ModelConfig):
    u = norm(lp.ln1, h, cfg.norm_eps)
    # bidirectional RoPE-free self attention == cross attention on u
    h = h + attention(lp.attn, u, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                      causal=False, cross_kv=u)
    return h + ffn(lp.mlp, norm(lp.ln2, h, cfg.norm_eps))


def _encode(params: EncDec, cfg: ModelConfig, audio_embeds, remat: bool):
    dt = dtype_of(cfg.dtype)
    x = audio_embeds.to(dt)
    x = x + _sinusoids(x.shape[1], cfg.d_model, x.device).to(dt)[None]
    for lp in params.enc_layers:
        x = checkpoint(_enc_block, lp, x, cfg, use_reentrant=False,
                       context_fn=remat_context()) \
            if remat else _enc_block(lp, x, cfg)
    return norm(params.enc_ln, x, cfg.norm_eps)


def encode(params: EncDec, cfg: ModelConfig,
           audio_embeds: torch.Tensor) -> torch.Tensor:
    """audio_embeds [B, T, D] (the frontend stub's output) -> encoder
    states [B, T, D] at ``cfg.dtype``."""
    return _encode(params, cfg, audio_embeds, _wants_remat(params, cfg))


def _dec_block(lp: DecLayer, h, enc, cfg: ModelConfig, positions):
    h = hint(h, DATA, MODEL, None)                 # SP boundary
    # each sublayer's input re-gathered to seq-replicated and its output
    # back to the boundary's layout, as a transformer block's (torch 2.11
    # refuses a matmul over batch and seq both sharded)
    h = h + hint(attention(lp.attn, _gathered(lp.ln1, h, cfg),
                           n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                           head_dim=cfg.hd, positions=positions,
                           causal=True, rope_theta=cfg.rope_theta),
                 DATA, MODEL, None)
    h = h + hint(attention(lp.xattn, _gathered(lp.lnx, h, cfg),
                           n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                           head_dim=cfg.hd, cross_kv=enc),
                 DATA, MODEL, None)
    return h + hint(ffn(lp.mlp, _gathered(lp.ln2, h, cfg)),
                    DATA, MODEL, None)


def _gathered(ln, h, cfg: ModelConfig):
    return hint(norm(ln, h, cfg.norm_eps), DATA, None, None)


def forward(params: EncDec, cfg: ModelConfig, tokens: torch.Tensor,
            audio_embeds: torch.Tensor, last_only: bool = False
            ) -> torch.Tensor:
    """Teacher-forced pass: encode the audio, decode the tokens.  tokens
    [B, S] -> logits [B, S, vocab] (fp32), ``last_only`` [B, 1, vocab].
    Each layer of both stacks is checkpointed when ``cfg.remat`` and a
    gradient is being taken."""
    return _forward(params, cfg, tokens, audio_embeds, last_only,
                    _wants_remat(params, cfg))


def _forward(params: EncDec, cfg: ModelConfig, tokens, audio_embeds,
             last_only: bool, remat: bool) -> torch.Tensor:
    enc = _encode(params, cfg, audio_embeds, remat)
    x = embed(params.embed, tokens, dtype_of(cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp in params.dec_layers:
        x = checkpoint(_dec_block, lp, x, enc, cfg, positions,
                       use_reentrant=False,
                       context_fn=remat_context()) \
            if remat else _dec_block(lp, x, enc, cfg, positions)
    # the unembedding's input is re-gathered to seq-replicated, as a
    # block's is (a matmul over batch and seq both sharded would
    # flatten two sharded dims)
    x = hint(norm(params.ln_f, x, cfg.norm_eps), DATA, None, None)
    if last_only:
        x = x[:, -1:]
    return unembed(params.embed, x)


# ------------------------------------------------------------------ decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> Dict[str, object]:
    """``{"self": AttnCache [L, B, Hk, max_len, hd] (head-major),
    "cross_k", "cross_v": [L, B, n_ctx, Hk, hd]}`` — the cross K/V
    seq-major bare tensors, as the reference lays them out."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    xshape = (cfg.n_layers, batch, cfg.encoder.n_ctx, cfg.n_kv_heads,
              cfg.hd)
    zeros = lambda sh: torch.zeros(sh, dtype=dtype, device=dev)  # noqa: E731
    return {"self": AttnCache(zeros(shape), zeros(shape), False),
            "cross_k": zeros(xshape), "cross_v": zeros(xshape)}


def prefill_cross(params: EncDec, cfg: ModelConfig, enc: torch.Tensor):
    """Every decoder layer's cross K/V from the encoder states ``enc``
    [B, T, D]: ``(k, v)``, each [L, B, T, Hk, hd] at ``enc``'s dtype."""
    sh = (*enc.shape[:-1], cfg.n_kv_heads, cfg.hd)
    ks = [dense(lp.xattn.wk, enc).reshape(sh) for lp in params.dec_layers]
    vs = [dense(lp.xattn.wv, enc).reshape(sh) for lp in params.dec_layers]
    return torch.stack(ks), torch.stack(vs)


def decode_step(params: EncDec, cfg: ModelConfig, cache: Dict[str, object],
                token: torch.Tensor, pos):
    """One decode step.  token [B] int; pos an int or an int tensor of
    shape () or [B].  Returns (logits [B, vocab] fp32, cache), the self
    cache updated in place; the cross K/V are read only."""
    dt = dtype_of(cfg.dtype)
    h = embed(params.embed, token[:, None], dt)     # [B, 1, D]
    b = h.shape[0]
    pos = torch.as_tensor(pos, device=h.device)     # once, not per layer
    sc_ = cache["self"]
    for l, lp in enumerate(params.dec_layers):
        y, _ = attn_decode(lp.attn, norm(lp.ln1, h, cfg.norm_eps),
                           AttnCache(sc_.k[l], sc_.v[l], sc_.ring), pos,
                           n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                           head_dim=cfg.hd, rope_theta=cfg.rope_theta)
        h = h + y
        # cross attention against the cached encoder K/V (no mask)
        u = norm(lp.lnx, h, cfg.norm_eps)
        q = _split_heads(dense(lp.xattn.wq, u), cfg.n_heads, cfg.hd)
        sc = _gqa_scores_grouped(q, cache["cross_k"][l].to(dt)).float() \
            * (cfg.hd ** -0.5)
        w = torch.softmax(sc, dim=-1).to(dt)
        o = _gqa_out_grouped(w, cache["cross_v"][l].to(dt)).reshape(
            b, 1, cfg.n_heads * cfg.hd)
        h = h + dense(lp.xattn.wo, o)
        h = h + ffn(lp.mlp, norm(lp.ln2, h, cfg.norm_eps))
    h = norm(params.ln_f, h, cfg.norm_eps)
    return unembed(params.embed, h)[:, 0], cache
