"""whisper-base [audio] — encoder-decoder, conv frontend stub.

6L d_model=512 8H (GQA kv=8) d_ff=2048 vocab=51865 [arXiv:2212.04356].
``input_specs`` supplies precomputed frame embeddings [B, 1500, 512] (the
conv1d×2+GELU frontend output).  Whisper flavor: LayerNorm + GELU MLP +
attention biases; the decoder's learned 448-position table is replaced by
RoPE so the assigned 4k/32k decoder shapes are well-defined (DESIGN.md).
"""
from repro_torch.models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                      # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51_865,
    head_dim=64,
    qkv_bias=True,
    norm_kind="ln",
    mlp_kind="gelu",
    encoder=EncoderConfig(n_layers=6, n_ctx=1500),
)
