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
    carries on quietly on the CPU.  A CUDA device without an index is the
    current one with its index (``cuda:0``), the device its tensors
    report, so the two compare equal."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """``a`` — a tensor, or anything numpy reads (host arrays, the JAX
    package's arrays, scalars) — as a tensor on ``device``.  numpy copies
    into a writable, contiguous array and keeps 0-d scalars 0-d.  bf16
    goes through its bits (:func:`repro_torch.core.precision
    .values_tensor`): an ``ml_dtypes`` bfloat16 array, which torch does not
    read, and any host array asked for at ``torch.bfloat16`` (``uint16``
    there is the port's bf16 carrier; floats round as the reference's
    ``astype(jnp.bfloat16)`` does)."""
    if not isinstance(a, torch.Tensor):
        a = np.array(a)
        if a.dtype.name == "bfloat16" or dtype == torch.bfloat16:
            from repro_torch.core.precision import values_tensor
            return values_tensor(a, device, torch.bfloat16).to(dtype=dtype)
        a = torch.from_numpy(a)
    return a.to(device=device, dtype=dtype)
