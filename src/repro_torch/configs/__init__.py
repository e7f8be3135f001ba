"""Architecture registry — ``--arch <id>`` resolution (a copy of
:mod:`repro.configs`; the port imports nothing of it).

``applicable(cfg, shape)`` encodes the assignment's skip rules:
`long_500k` needs sub-quadratic attention (SSM / hybrid / windowed);
pure full-attention archs record ``SKIP(reason)``.

The reference's ``input_specs`` builds JAX ``ShapeDtypeStruct``s for its
dry-run; it is ported with ``launch/dryrun.py``.
"""
from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.configs.shapes import SHAPES, Shape
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config", "applicable", "SHAPES", "Shape", "cells"]

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


def cells(archs=None, shapes=None):
    """Iterate (arch, shape, runs?, skip_reason) over the full matrix."""
    archs = archs or list(ARCHS)
    shapes = shapes or list(SHAPES)
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            ok, why = applicable(cfg, SHAPES[s])
            yield a, s, ok, why
