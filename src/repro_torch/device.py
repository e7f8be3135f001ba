"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "to_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another.  A CUDA device without a card raises — the port never
    carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """``a`` — a tensor, or anything numpy reads (host arrays, the JAX
    package's arrays, scalars) — as a tensor on ``device``.  numpy copies
    into a writable, contiguous array and keeps 0-d scalars 0-d."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=dtype)
