"""Carry packed operands and solver state across from numpy.

The JAX package's stacked operands (``StackedRowEll`` / ``StackedSell`` /
``StackedEllpack``), its single-system operators and matrices
(``BellOperator`` / ``BellMatrix``, ``PallasEllOperator`` /
``EllpackMatrix``) and its solver states (``BatchedVMState``,
``CGState``) are plain containers of arrays; :func:`numpy.asarray` turns
every array in them into host numpy.  These helpers read such objects by
attribute — importing nothing from the JAX package — and return what the
port's solvers, runners and steppers consume, so one packed operand or
one mid-flight state can be fed to both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.operators import BellOperator
from repro_torch.core.phases import CGState
from repro_torch.core.precision import get_scheme
from repro_torch.core.vm import BatchedVMState
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels.ops import EllKernelOperator
from repro_torch.sparse.bell import BellMatrix
from repro_torch.sparse.ellpack import EllpackMatrix

__all__ = ["stacked_to_torch", "vm_state_to_torch", "vm_state_to_numpy",
           "operator_to_torch", "cg_state_to_torch"]


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
        return (to_device(stacked.cols, device),
                to_device(stacked.vals, device),
                to_device(stacked.iperm, device, torch.int64))
    if hasattr(stacked, "tile_cols"):
        dtype = None if scheme is None else scheme.matrix_dtype
        return (to_device(stacked.tile_cols, device),
                to_device(stacked.vals, device, dtype),
                to_device(stacked.local_cols, device))
    return to_device(stacked.cols, device), to_device(stacked.vals, device)


def vm_state_to_torch(state, *, device=None) -> BatchedVMState:
    """A port :class:`~repro_torch.core.vm.BatchedVMState` from any object
    with the VM state's fields (``k it status mem queues sregs active
    trace``) holding arrays."""
    device = resolve_device(device)
    return BatchedVMState(*(to_device(getattr(state, f), device)
                            for f in BatchedVMState._fields))


def vm_state_to_numpy(state: BatchedVMState) -> dict:
    """Host snapshot ``{field: np.ndarray}`` of a port VM state."""
    return {f: getattr(state, f).to("cpu", copy=True).numpy()
            for f in BatchedVMState._fields}


def operator_to_torch(obj, *, scheme=None, diag=None, device=None):
    """The port's single-system operator from a banked-ELL or ELLPACK
    operand read by attribute.

    * an operator (has ``diag`` and ``scheme``: the reference's
      ``BellOperator`` / ``PallasEllOperator``) keeps its arrays, its
      values at its scheme's matrix dtype and its diag;
    * a matrix (``BellMatrix`` / ``EllpackMatrix``) needs ``scheme`` and
      ``diag``.

    Banked ELL (has ``local_rows``) becomes a
    :class:`~repro_torch.core.operators.BellOperator` (``backend="xla"``),
    ELLPACK an :class:`~repro_torch.kernels.ops.EllKernelOperator`
    (``backend="pallas"``).
    """
    if hasattr(obj, "scheme") and hasattr(obj, "diag"):
        scheme = obj.scheme.name if scheme is None else scheme
        diag = obj.diag if diag is None else diag
        shape = (obj.n, obj.n)
    elif scheme is None or diag is None:
        raise ValueError("a matrix operand needs scheme= and diag=")
    else:
        shape = tuple(obj.shape)
    scheme = get_scheme(scheme)
    diag = np.asarray(diag)
    common = dict(tile_cols=np.asarray(obj.tile_cols),
                  vals=np.asarray(obj.vals),
                  local_cols=np.asarray(obj.local_cols), shape=shape,
                  block_rows=obj.block_rows, col_tile=obj.col_tile,
                  nnz=obj.nnz)
    if hasattr(obj, "local_rows"):
        m = BellMatrix(local_rows=np.asarray(obj.local_rows), **common)
        return BellOperator.from_bell(m, scheme, diag, device)
    return EllKernelOperator.from_ellpack(EllpackMatrix(**common), scheme,
                                          diag, device)


def cg_state_to_torch(state, *, device=None) -> CGState:
    """A port :class:`~repro_torch.core.phases.CGState` from any object
    with the single-system state's fields (``i x r p rz rr trace``)."""
    device = resolve_device(device)
    return CGState(*(to_device(getattr(state, f), device)
                     for f in CGState._fields))
