"""Architecture registry — ``--arch <id>`` resolution and input specs (a
copy of :mod:`repro.configs`; the port imports nothing of it).

``input_specs(arch, shape)`` returns stand-ins for every model input of
that (architecture × shape) cell: tensors on the ``meta`` device, which
carry shape and dtype and allocate nothing (the reference's
``ShapeDtypeStruct``s).

``applicable(cfg, shape)`` encodes the assignment's skip rules:
`long_500k` needs sub-quadratic attention (SSM / hybrid / windowed);
pure full-attention archs record ``SKIP(reason)``.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

import torch

from repro_torch.configs.shapes import SHAPES, Shape
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config", "input_specs", "applicable", "SHAPES",
           "Shape", "cells"]

#: arch id -> module (one file per assigned architecture)
ARCHS = {
    "zamba2-1.2b": "zamba2_1_2b",
    "whisper-base": "whisper_base",
    "granite-34b": "granite_34b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "qwen2.5-32b": "qwen2_5_32b",
    "gemma3-1b": "gemma3_1b",
    "mamba2-780m": "mamba2_780m",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "internvl2-76b": "internvl2_76b",
}


def get_config(arch: str) -> ModelConfig:
    if isinstance(arch, ModelConfig):
        return arch
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.CONFIG


def applicable(cfg: ModelConfig, shape: Shape) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's skip rules."""
    if shape.needs_subquadratic and not cfg.supports_long_context:
        return False, ("full attention is O(S^2)/O(S)-state at 500k; "
                       "skip per assignment (sub-quadratic archs only)")
    if shape.kind == "decode" and cfg.encoder is not None \
            and shape.needs_subquadratic:
        return False, "enc-dec decoder is full-attention at 500k"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _extras(cfg: ModelConfig, batch: int) -> Dict[str, torch.Tensor]:
    from repro_torch.models.transformer import dtype_of
    dt = dtype_of(cfg.dtype)
    out = {}
    if cfg.n_patches:
        out["patch_embeds"] = _meta((batch, cfg.n_patches, cfg.d_model), dt)
    if cfg.encoder is not None:
        out["audio_embeds"] = _meta((batch, cfg.encoder.n_ctx, cfg.d_model),
                                    dt)
    return out


def input_specs(arch, shape_name: str,
                cache_dtype=torch.bfloat16) -> Dict[str, object]:
    """``meta``-device inputs for one (arch × shape) cell; tokens, labels
    and positions are int64 (torch's index dtype).

    train:   {tokens, labels} (+ frontend embeddings)
    prefill: {tokens} (+ frontend embeddings)
    decode:  {token, pos, cache} — the model's ``init_cache`` laid out on
             the ``meta`` device.

    A skipped cell (:func:`applicable`) raises ``ValueError``."""
    from repro_torch.models.api import init_cache
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} × {shape_name}: SKIP({why})")
    b, i64 = shape.global_batch, torch.int64
    if shape.kind == "train":
        return {"tokens": _meta((b, shape.seq_len), i64),
                "labels": _meta((b, shape.seq_len), i64),
                **_extras(cfg, b)}
    if shape.kind == "prefill":
        return {"tokens": _meta((b, shape.seq_len), i64),
                **_extras(cfg, b)}
    # decode: one new token against a cache of seq_len context
    return {"token": _meta((b,), i64), "pos": _meta((), i64),
            "cache": init_cache(cfg, b, shape.seq_len, dtype=cache_dtype,
                                device="meta")}


def cells(archs=None, shapes=None):
    """Iterate (arch, shape, runs?, skip_reason) over the full matrix."""
    archs = archs or list(ARCHS)
    shapes = shapes or list(SHAPES)
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            ok, why = applicable(cfg, SHAPES[s])
            yield a, s, ok, why
