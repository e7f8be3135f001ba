"""Family-dispatching model API — the port of :mod:`repro.models.api`, the
surface the server and the trainer (:mod:`repro_torch.train`) consume.

``batch`` dicts: ``{"tokens": [B,S] int, "labels": [B,S] int}``, plus
``{"patch_embeds": [B,P,D]}`` for the VLM.  Only the dense family is
ported: the ``ssm``/``hybrid``/``encdec`` families (and MoE, in
:mod:`~repro_torch.models.transformer`) raise ``NotImplementedError``
until they are (ROADMAP A.11).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

__all__ = ["init_params", "forward_logits", "loss_fn", "init_cache",
           "decode_step", "count_params"]


def _mod(cfg: ModelConfig):
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            "(models/ssm.py, hybrid.py; ROADMAP A.11)")
    if cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet "
            "(models/encdec.py; ROADMAP A.11)")
    return transformer


def init_params(cfg: ModelConfig,
                generator: Optional[torch.Generator] = None, *, device=None):
    return _mod(cfg).init_params(cfg, generator, device=device)


def forward_logits(params, cfg: ModelConfig, batch: Dict[str, Any],
                   last_only: bool = False) -> torch.Tensor:
    return _mod(cfg).forward(params, cfg, batch["tokens"],
                             extra_embeds=batch.get("patch_embeds"),
                             last_only=last_only)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any]) -> torch.Tensor:
    """Mean next-token cross entropy (fp32 logits)."""
    logits = forward_logits(params, cfg, batch)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
    return (lse - picked).mean()


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None):
    return _mod(cfg).init_cache(cfg, batch, max_len, dtype, device=device)


def decode_step(params, cfg: ModelConfig, cache, token: torch.Tensor, pos):
    return _mod(cfg).decode_step(params, cfg, cache, token, pos)


def count_params(params: torch.nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
