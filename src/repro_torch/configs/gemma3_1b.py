"""gemma3-1b [dense] — 5:1 local:global attention interleave, 262k vocab.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144
[hf:google/gemma-3-1b-pt].  Local layers use a 512-token sliding window
(ring KV cache), every 6th layer is global ⇒ `long_500k` runs; the global
layers' O(S) decode cost is the noted caveat (DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262_144,
    head_dim=256,
    sliding_window=512,
    local_global_ratio=5,
    rope_theta=1_000_000.0,
)
