"""LM model substrate of the port — dense family
(:mod:`~repro_torch.models.transformer`), dispatched through
:mod:`repro_torch.models.api`.  Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``."""
from repro_torch.models.api import (count_params, decode_step, forward_logits,
                                    init_cache, init_params, loss_fn)
from repro_torch.models.config import (EncoderConfig, ModelConfig, MoEConfig,
                                       SSMConfig)

__all__ = ["init_params", "forward_logits", "loss_fn", "init_cache",
           "decode_step", "count_params", "ModelConfig", "MoEConfig",
           "SSMConfig", "EncoderConfig"]
