"""llama4-scout-17b-a16e [moe] — 16 experts, top-1 routing.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 (per expert) vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E].  Early fusion is multimodal input
plumbing — the assigned shapes are text-only, so the frontend is N/A here
(DESIGN.md §Arch-applicability).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202_048,
    head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=1, capacity_factor=1.25),
    tie_embeddings=False,
)
