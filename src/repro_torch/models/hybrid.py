"""SSM and hybrid LMs — the port of :mod:`repro.models.hybrid`:
mamba2-780m (a pure SSD stack) and zamba2 (an SSD backbone plus one
*shared* attention block invoked after every ``attn_every`` layers, its
weights reused across invocations).

Decode state is O(1) in sequence length for the SSD layers; each of
zamba2's shared-attention invocations keeps its own KV cache slot (same
weights, other activations).  As in the reference, the released zamba2
checkpoints' per-invocation LoRA deltas and concat-input variant are left
out: the shared block is a standard pre-norm attention + MLP pair.

Entry points as :mod:`~repro_torch.models.transformer`'s:
:func:`init_params`, :func:`forward` (each SSD layer checkpointed when
``cfg.remat`` asks and a gradient is taken; the shared block is not, as in
the reference), :func:`init_cache` and :func:`decode_step`.
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
from repro_torch.models.layers import (MLP, Embedding, draw_parameters,
                                       embed, ffn, make_norm, norm, unembed)
from repro_torch.models.ssm import (Mamba2, SSMCache, mamba2_decode,
                                    mamba2_forward)
from repro_torch.models.transformer import dtype_of

__all__ = ["Hybrid", "init_params", "forward", "init_cache", "decode_step"]


def _n_inv(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


class SSMLayer(nn.Module):
    """``ln`` and ``ssm``: one pre-norm residual SSD layer."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.ln = make_norm(cfg.d_model, cfg.norm_kind, device=device)
        self.ssm = Mamba2(cfg.d_model, cfg.ssm, device=device)


class SharedBlock(nn.Module):
    """zamba2's shared block: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.ln1 = make_norm(cfg.d_model, cfg.norm_kind, device=device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, device=device)
        self.ln2 = make_norm(cfg.d_model, cfg.norm_kind, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, device=device)


class Hybrid(nn.Module):
    """The LM's parameters: ``embed`` (tied), ``layers``, ``ln_f`` and,
    when ``attn_every > 0``, ``shared`` — the reference's pytree keys.
    Allocated, not drawn: see :func:`init_params`."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab, cfg.d_model, device=device)
        self.layers = nn.ModuleList(SSMLayer(cfg, device=device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = make_norm(cfg.d_model, cfg.norm_kind, device=device)
        self.shared = SharedBlock(cfg, device=device) if cfg.attn_every \
            else None

    def forward(self, tokens: torch.Tensor,
                extra_embeds: Optional[torch.Tensor] = None,
                last_only: bool = False) -> torch.Tensor:
        """:func:`forward` with this module's config, always without remat
        (for ``torch.func.functional_call``; see
        :meth:`repro_torch.models.transformer.Transformer.forward`)."""
        return _forward(self, self.cfg, tokens, extra_embeds, last_only,
                        remat=False)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> Hybrid:
    """Random parameters on ``device`` (default ``cuda``), drawn from
    ``generator`` with the reference's distributions and scales (see
    :func:`repro_torch.models.transformer.init_params`)."""
    dev = resolve_device(device)
    return draw_parameters(Hybrid(cfg, device=dev), generator)


def _shared_block(sp: SharedBlock, x, cfg: ModelConfig, positions):
    # the inputs re-gathered to seq-replicated and the outputs back to the
    # SP layout, as a transformer block's are (the reference has no hint
    # here; on a 2×16×16 mesh DTensor spends minutes searching a layout
    # for the seq-sharded matmul, and torch 2.11 refuses its backward)
    u = hint(norm(sp.ln1, x, cfg.norm_eps), DATA, None, None)
    h = x + hint(attention(sp.attn, u, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                           positions=positions, causal=True,
                           rope_theta=cfg.rope_theta), DATA, MODEL, None)
    return h + hint(ffn(sp.mlp, hint(norm(sp.ln2, h, cfg.norm_eps),
                                     DATA, None, None)), DATA, MODEL, None)


def _ssm_layer(lp: SSMLayer, h, cfg: ModelConfig):
    h = hint(h, DATA, MODEL, None)                 # SP boundary
    # gather the block input (small) so in_proj stays sharded
    u = hint(norm(lp.ln, h, cfg.norm_eps), DATA, None, None)
    return h + hint(mamba2_forward(lp.ssm, u, cfg.d_model, cfg.ssm,
                                   norm_eps=cfg.norm_eps),
                    DATA, MODEL, None)


def _layer_groups(cfg: ModelConfig):
    """Split the layer stack into runs of ``attn_every`` SSD layers, each
    (except a remainder) followed by one shared-attention invocation:
    ``[(start, length, attn_after?)]``."""
    L, every = cfg.n_layers, cfg.attn_every
    if not every:
        return [(0, L, False)]
    out = []
    start = 0
    while start + every <= L:
        out.append((start, every, True))
        start += every
    if start < L:
        out.append((start, L - start, False))
    return out


def forward(params: Hybrid, cfg: ModelConfig, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None,
            last_only: bool = False) -> torch.Tensor:
    """tokens [B, S] (+ optional prepended embeddings [B, P, D]) -> fp32
    logits [B, S, vocab] over the tokens (``last_only``: [B, 1, vocab])."""
    remat = cfg.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in params.parameters())
    return _forward(params, cfg, tokens, extra_embeds, last_only, remat)


def _forward(params: Hybrid, cfg: ModelConfig, tokens, extra_embeds,
             last_only: bool, remat: bool) -> torch.Tensor:
    dt = dtype_of(cfg.dtype)
    x = embed(params.embed, tokens, dt)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(dt), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for start, length, attn_after in _layer_groups(cfg):
        for lp in params.layers[start:start + length]:
            x = checkpoint(_ssm_layer, lp, x, cfg, use_reentrant=False,
                           context_fn=remat_context()) \
                if remat else _ssm_layer(lp, x, cfg)
        if attn_after and params.shared is not None:
            x = _shared_block(params.shared, x, cfg, positions)
    # the unembedding's input is re-gathered to seq-replicated, as a
    # block's is (a matmul over batch and seq both sharded would
    # flatten two sharded dims)
    x = hint(norm(params.ln_f, x, cfg.norm_eps), DATA, None, None)
    if last_only:
        x = x[:, -1:]
    elif extra_embeds is not None:
        x = x[:, extra_embeds.shape[1]:]
    return unembed(params.embed, x)


# ------------------------------------------------------------------ decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> Dict[str, object]:
    """``{"ssm": SSMCache}`` stacked ``[L, B, …]`` (constant in
    ``max_len``), plus ``{"attn": AttnCache}`` ``[n_inv, B, Hk, max_len,
    hd]`` for the shared block's invocations."""
    dev = resolve_device(device)
    di = cfg.ssm.d_inner(cfg.d_model)
    h = cfg.ssm.n_ssm_heads(cfg.d_model)
    L = cfg.n_layers
    kw = dict(dtype=dtype, device=dev)
    cache = {"ssm": SSMCache(
        conv=torch.zeros(L, batch, cfg.ssm.d_conv - 1,
                         di + 2 * cfg.ssm.d_state, **kw),
        ssm=torch.zeros(L, batch, h, cfg.ssm.headdim, cfg.ssm.d_state,
                        **kw))}
    n_inv = _n_inv(cfg)
    if n_inv:
        shape = (n_inv, batch, cfg.n_kv_heads, max_len, cfg.hd)
        cache["attn"] = AttnCache(torch.zeros(shape, **kw),
                                  torch.zeros(shape, **kw), False)
    return cache


def decode_step(params: Hybrid, cfg: ModelConfig, cache, token: torch.Tensor,
                pos):
    """One decode step.  token [B] int; pos an int or an int tensor of
    shape () or [B].  Returns (logits [B, vocab] fp32, cache), the cache
    updated in place."""
    dt = dtype_of(cfg.dtype)
    x = embed(params.embed, token[:, None], dt)           # [B, 1, D]
    pos = torch.as_tensor(pos, device=x.device)
    ssm, shared = cache["ssm"], params.shared
    inv = 0
    for start, length, attn_after in _layer_groups(cfg):
        for l in range(start, start + length):
            lp = params.layers[l]
            y, _ = mamba2_decode(lp.ssm, norm(lp.ln, x, cfg.norm_eps),
                                 SSMCache(ssm.conv[l], ssm.ssm[l]),
                                 cfg.d_model, cfg.ssm, norm_eps=cfg.norm_eps)
            x = x + y
        if attn_after and shared is not None:
            # shared weights, a distinct KV slot per invocation
            kv = cache["attn"]
            y, _ = attn_decode(shared.attn, norm(shared.ln1, x, cfg.norm_eps),
                               AttnCache(kv.k[inv], kv.v[inv], False), pos,
                               n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                               head_dim=cfg.hd, rope_theta=cfg.rope_theta)
            x = x + y
            x = x + ffn(shared.mlp, norm(shared.ln2, x, cfg.norm_eps))
            inv += 1
    x = norm(params.ln_f, x, cfg.norm_eps)
    return unembed(params.embed, x)[:, 0], cache
