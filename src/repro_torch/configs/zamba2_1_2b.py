"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf].  The shared transformer block (attention + MLP,
weights reused) fires every 6 SSD layers; the released checkpoints' LoRA
per-invocation deltas are omitted (DESIGN.md §Arch-applicability).
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32_000,
    head_dim=64,
    ssm=SSMConfig(d_state=64, expand=2, d_conv=4, headdim=64, chunk=256),
    attn_every=6,
)
