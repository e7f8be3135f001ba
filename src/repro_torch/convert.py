"""Carry packed operands and solver state across from numpy.

The JAX package's stacked operands (``StackedRowEll`` / ``StackedSell`` /
``StackedEllpack``) and its ``BatchedVMState`` are plain containers of
arrays; :func:`numpy.asarray` turns every array in them into host numpy.
These helpers read such objects by attribute — importing nothing from
the JAX package — and return the tensors the port's runners and steppers
consume, so one packed bag or one mid-flight state can be fed to both
packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.vm import BatchedVMState
from repro_torch.device import resolve_device

__all__ = ["stacked_to_torch", "vm_state_to_torch", "vm_state_to_numpy"]


def _t(a, device, dtype=None) -> torch.Tensor:
    # np.array copies into a writable, contiguous array and keeps 0-d
    # scalars (the VM's tick counter) 0-d
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def stacked_to_torch(stacked, *, scheme=None, device=None) -> tuple:
    """The matvec operand tuple of a stacked bag.

    * sliced-ELL (has ``iperm``): ``(cols, vals, iperm)``, ``iperm`` as
      int64 for ``torch.gather``;
    * row-ELL (has ``cols``): ``(cols, vals)``;
    * ELLPACK (has ``tile_cols``): ``(tile_cols, vals, local_cols)``, the
      values cast to ``scheme.matrix_dtype`` (the ELLPACK stacker keeps
      them at the CSR's dtype).
    """
    device = resolve_device(device)
    if hasattr(stacked, "iperm"):
        return (_t(stacked.cols, device), _t(stacked.vals, device),
                _t(stacked.iperm, device, torch.int64))
    if hasattr(stacked, "tile_cols"):
        dtype = None if scheme is None else scheme.matrix_dtype
        return (_t(stacked.tile_cols, device), _t(stacked.vals, device, dtype),
                _t(stacked.local_cols, device))
    return _t(stacked.cols, device), _t(stacked.vals, device)


def vm_state_to_torch(state, *, device=None) -> BatchedVMState:
    """A port :class:`~repro_torch.core.vm.BatchedVMState` from any object
    with the VM state's fields (``k it status mem queues sregs active
    trace``) holding arrays."""
    device = resolve_device(device)
    return BatchedVMState(*(_t(getattr(state, f), device)
                            for f in BatchedVMState._fields))


def vm_state_to_numpy(state: BatchedVMState) -> dict:
    """Host snapshot ``{field: np.ndarray}`` of a port VM state."""
    return {f: getattr(state, f).to("cpu", copy=True).numpy()
            for f in BatchedVMState._fields}
