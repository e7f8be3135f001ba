"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 [arXiv:2401.16818].
SWA width 4096 ⇒ sub-quadratic decode: `long_500k` RUNS with an O(w) ring
KV cache.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10_240,
    vocab=32_000,
    head_dim=120,
    sliding_window=4096,
)
