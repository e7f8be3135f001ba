"""LM model substrate of the port — the decoder-only families (dense, MoE,
VLM: :mod:`~repro_torch.models.transformer`), the SSM and hybrid ones
(:mod:`~repro_torch.models.hybrid`) and the encoder-decoder one
(:mod:`~repro_torch.models.encdec`), dispatched through
:mod:`repro_torch.models.api`.  Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``."""
from repro_torch.models.api import (count_params, decode_step, forward_logits,
                                    init_cache, init_params, loss_fn,
                                    model_class)
from repro_torch.models.config import (EncoderConfig, ModelConfig, MoEConfig,
                                       SSMConfig)

__all__ = ["init_params", "forward_logits", "loss_fn", "init_cache",
           "decode_step", "count_params", "model_class", "ModelConfig",
           "MoEConfig", "SSMConfig", "EncoderConfig"]
