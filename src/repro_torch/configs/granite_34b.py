"""granite-34b [dense] — code model, MQA (single KV head).

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152 [arXiv:2405.04324; hf].
GPT-BigCode lineage: 2-matrix GELU MLP (d_ff = 4·d_model) — with it the
param count lands at ~34B as published; a SwiGLU MLP would be ~47B.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24_576,
    vocab=49_152,
    head_dim=128,
    mlp_kind="gelu",
    norm_kind="ln",
)
