"""Model configuration — one dataclass covering all ten assigned families
(a copy of :mod:`repro.models.config`; the port imports nothing of it).

A single ``ModelConfig`` describes dense / GQA / SWA / local-global / MoE /
SSM / hybrid / encoder-decoder / frontend-stub architectures; family-specific
fields are ``None``/0 when unused.  ``reduced()`` derives the small
same-family config used by the CPU tests; the port runs the dense family at
its full config on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "EncoderConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    d_conv: int = 4
    headdim: int = 64
    chunk: int = 256         # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper) — frontend is a stub:
    ``input_specs`` supplies precomputed frame/patch embeddings."""
    n_layers: int
    n_ctx: int               # encoder positions (1500 audio frames / patches)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None       # default d_model // n_heads
    qkv_bias: bool = False               # qwen2.5
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # --- attention pattern -------------------------------------------------
    sliding_window: Optional[int] = None     # SWA width (h2o-danube)
    local_global_ratio: int = 0              # gemma3: N local per 1 global
    # --- mixture of experts -------------------------------------------------
    moe: Optional[MoEConfig] = None
    # --- state space --------------------------------------------------------
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0      # hybrid (zamba2): shared attn every k layers
    # --- encoder-decoder / multimodal frontend stubs ------------------------
    encoder: Optional[EncoderConfig] = None
    n_patches: int = 0       # vlm: patch embeddings prepended to the sequence
    # --- block flavor --------------------------------------------------------
    norm_kind: str = "rms"       # "rms" | "ln" (whisper)
    mlp_kind: str = "swiglu"     # "swiglu" | "gelu" (whisper)
    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True       # checkpoint each block in the train step

    # -------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM, hybrid, or windowed attention."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None
                or self.local_global_ratio > 0)

    @property
    def has_decoder(self) -> bool:
        return True          # all assigned archs decode (whisper: decoder side)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, L, hd = self.d_model, self.d_ff, self.n_layers, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + self.n_heads * hd * d
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            nh = self.ssm.n_ssm_heads(d)
            ssm_blk = d * (2 * di + 2 * self.ssm.d_state + nh) + di * d \
                + self.ssm.d_conv * (di + 2 * self.ssm.d_state) + 2 * nh
        else:
            ssm_blk = 0
        n_mats = 2 if self.mlp_kind == "gelu" else 3
        if self.moe is not None:
            ffn = self.moe.n_experts * 3 * d * f + d * self.moe.n_experts
        else:
            ffn = n_mats * d * f
        if self.family == "ssm":
            blocks = L * (ssm_blk + d)
        elif self.family == "hybrid":
            n_attn = L // max(self.attn_every, 1)
            blocks = L * (ssm_blk + d) + (attn + 3 * d * f + 2 * d)  # shared
            blocks += 0 * n_attn
        else:
            blocks = L * (attn + ffn + 2 * d)
        if self.encoder is not None:
            blocks += self.encoder.n_layers * (2 * attn + 3 * d * f + 3 * d)
            blocks += L * attn               # decoder cross-attention
        return emb + blocks + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts) — the N in
        MODEL_FLOPS = 6·N·D."""
        if self.moe is None:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        all_experts = L * self.moe.n_experts * 3 * d * f
        active = L * self.moe.top_k * 3 * d * f
        return self.param_count() - all_experts + active

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.attn_every == 0
                         else 2 * self.attn_every),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=256,
            vocab=512,
            head_dim=32,
            sliding_window=64 if self.sliding_window else None,
            moe=(dataclasses.replace(self.moe, n_experts=min(
                self.moe.n_experts, 8), top_k=min(self.moe.top_k, 2))
                if self.moe else None),
            ssm=(dataclasses.replace(self.ssm, d_state=16, headdim=32,
                                     chunk=32) if self.ssm else None),
            encoder=(dataclasses.replace(self.encoder, n_layers=2, n_ctx=64)
                     if self.encoder else None),
            n_patches=16 if self.n_patches else 0,
            dtype="float32",
            remat=False,
        )
