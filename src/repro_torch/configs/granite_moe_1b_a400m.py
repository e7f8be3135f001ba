"""granite-moe-1b-a400m [moe] — 32 experts, top-8 routing.

24L d_model=1024 16H (GQA kv=8) d_ff=512 (per expert) vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base].
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49_155,
    head_dim=64,
    moe=MoEConfig(n_experts=32, top_k=8, capacity_factor=1.25),
)
