"""Family-dispatching model API — the port of :mod:`repro.models.api`, the
surface the server and the trainer (:mod:`repro_torch.train`) consume.

``batch`` dicts: ``{"tokens": [B,S] int, "labels": [B,S] int}``, plus
``{"patch_embeds": [B,P,D]}`` for the VLM and ``{"audio_embeds":
[B,T,D]}`` for the encoder-decoder family.  The decoder-only families
(dense, MoE, VLM) run through :mod:`~repro_torch.models.transformer`, the
``ssm`` and ``hybrid`` families through :mod:`~repro_torch.models.hybrid`,
the encoder-decoder one (whisper) through
:mod:`~repro_torch.models.encdec`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.distributed.hints import is_dtensor
from repro_torch.models import encdec, hybrid, transformer
from repro_torch.models.config import ModelConfig

__all__ = ["init_params", "forward_logits", "loss_fn", "init_cache",
           "decode_step", "count_params", "model_class"]


def _mod(cfg: ModelConfig):
    if cfg.family in ("ssm", "hybrid"):
        return hybrid
    if cfg.encoder is not None:
        return encdec
    return transformer


def model_class(cfg: ModelConfig) -> type:
    """The ``nn.Module`` that holds ``cfg``'s parameters
    (:class:`~repro_torch.models.transformer.Transformer`,
    :class:`~repro_torch.models.hybrid.Hybrid` or
    :class:`~repro_torch.models.encdec.EncDec`): built as
    ``model_class(cfg)(cfg, device=...)``, not drawn."""
    return {hybrid: hybrid.Hybrid, encdec: encdec.EncDec}.get(
        _mod(cfg), transformer.Transformer)


def init_params(cfg: ModelConfig,
                generator: Optional[torch.Generator] = None, *, device=None):
    return _mod(cfg).init_params(cfg, generator, device=device)


def forward_logits(params, cfg: ModelConfig, batch: Dict[str, Any],
                   last_only: bool = False) -> torch.Tensor:
    if cfg.encoder is not None:
        return encdec.forward(params, cfg, batch["tokens"],
                              batch["audio_embeds"], last_only=last_only)
    return _mod(cfg).forward(params, cfg, batch["tokens"],
                             extra_embeds=batch.get("patch_embeds"),
                             last_only=last_only)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any]) -> torch.Tensor:
    """Mean next-token cross entropy (fp32 logits).  On DTensors (the
    sharded train step) the tied unembedding leaves the logits sharded on
    vocab: each rank takes the losses of the rows it holds with the vocab
    whole (``local_map``; DTensor's rule for the gather's backward builds
    zeros of the global logits' size on every rank), and the mean is a
    DTensor."""
    logits = forward_logits(params, cfg, batch)
    if not is_dtensor(logits):
        return _token_losses(logits, batch["labels"]).mean()
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = [p if p.is_shard(0) else Replicate() for p in logits.placements]
    return local_map(_token_losses, out_placements=pl,
                     in_placements=(pl, pl), redistribute_inputs=True)(
        logits, batch["labels"]).mean()


def _token_losses(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """``logsumexp(logits) − logits[label]`` at each position."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return lse - picked


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None):
    return _mod(cfg).init_cache(cfg, batch, max_len, dtype, device=device)


def decode_step(params, cfg: ModelConfig, cache, token: torch.Tensor, pos):
    return _mod(cfg).decode_step(params, cfg, cache, token, pos)


def count_params(params: torch.nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
