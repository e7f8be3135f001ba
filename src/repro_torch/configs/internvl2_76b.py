"""internvl2-76b [vlm] — InternViT frontend stub + InternLM2-style backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 [arXiv:2404.16821].
``input_specs`` supplies 256 precomputed patch embeddings [B, 256, 8192]
(the InternViT + pixel-shuffle + MLP projector output) prepended to the
token sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab=128_256,
    head_dim=128,
    n_patches=256,
    tie_embeddings=False,
)
