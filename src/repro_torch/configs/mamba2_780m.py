"""mamba2-780m [ssm] — attention-free SSD (state-space duality) stack.

48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128 [arXiv:2405.21060].
d_inner = 3072, headdim 64 ⇒ 48 SSD heads.  Decode state is O(1) in
sequence length ⇒ all four shapes including `long_500k` run.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,            # attention-free: unused
    n_kv_heads=1,
    d_ff=0,
    vocab=50_280,
    head_dim=64,
    ssm=SSMConfig(d_state=128, expand=2, d_conv=4, headdim=64, chunk=256),
)
