"""Training substrate of the port: AdamW, CGGN, the train step and host
loop, synthetic data, checkpoints and the fault hooks (the torch port of
:mod:`repro.train`).  Entry points run on ``"cuda"`` unless the caller
passes ``device="cpu"``."""
from repro_torch.train.cggn import CGGNConfig, CGGNState, cggn_init, cggn_update
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.loop import Trainer, TrainerConfig, make_train_step
from repro_torch.train.optim import (AdamWConfig, adamw_init, adamw_update,
                                     cosine_schedule)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "CGGNConfig", "CGGNState", "cggn_init", "cggn_update",
           "DataConfig", "SyntheticLM", "Trainer", "TrainerConfig",
           "make_train_step"]
