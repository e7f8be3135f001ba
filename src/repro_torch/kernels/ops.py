"""The kernels as the single-system solver consumes them — the
``backend="pallas"`` path (the port of :mod:`repro.kernels.ops`).

* :func:`ell_operator_pallas` (alias ``bell_operator_pallas``) wraps a
  sparse matrix as an :class:`EllKernelOperator`, whose ``matvec`` is the
  banked-ELLPACK SpMV kernel :func:`~repro_torch.kernels.spmv.spmv_ell`.
* :func:`make_phase_ops` returns the dot, fused phase-2 and fused phase-3
  kernels in the signature :func:`repro_torch.core.phases.jpcg_loop`
  consumes, so the loop body runs the paper's three phases as one SpMV
  plus three kernels.
* :func:`make_dot3` returns the fused triple dot of pipelined CG.

The reference's ``interpret`` flag has no counterpart: each wrapper takes
its plain version for CPU tensors and launches its kernel for CUDA
tensors.  :func:`launches` and :func:`reset_launches` read and clear the
launch counts of every kernel of the port, ``flash_attention`` and the
CSR-to-ELLPACK packer (:mod:`repro_torch.kernels.pack`) included.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.metrics import solver_metrics
from repro_torch.core.precision import PrecisionScheme, get_scheme
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels import dot as _dot
from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import fused_phase as _fused
from repro_torch.kernels import pack as _pack
from repro_torch.kernels import spmv as _spmv
from repro_torch.sparse.csr import CSRMatrix, csr_from_coo
from repro_torch.sparse.ellpack import EllpackMatrix

__all__ = ["EllKernelOperator", "ell_operator_pallas", "bell_operator_pallas",
           "make_phase_ops", "make_dot3", "launches", "reset_launches"]

_KERNEL_MODULES = (_spmv, _dot, _fused, _flash, _pack)


def launches() -> Dict[str, int]:
    """Launches of every kernel since the last :func:`reset_launches`."""
    out: Dict[str, int] = {}
    for mod in _KERNEL_MODULES:
        out.update(mod.LAUNCHES)
    return out


def reset_launches() -> None:
    for mod in _KERNEL_MODULES:
        mod.reset_launches()


@dataclasses.dataclass(frozen=True)
class EllKernelOperator:
    """ELLPACK matrix whose matvec is the SpMV kernel (the port of
    ``repro.kernels.ops.PallasEllOperator``)."""

    tile_cols: torch.Tensor   # int32[B, T]
    vals: torch.Tensor        # matrix_dtype[B, T, E, R]
    local_cols: torch.Tensor  # int32[B, T, E, R]
    diag: torch.Tensor        # vector_dtype[n]
    n: int
    block_rows: int
    col_tile: int
    padded_cols: int
    scheme: PrecisionScheme
    nnz: int

    @classmethod
    def from_ellpack(cls, m: EllpackMatrix, scheme, diag,
                     device=None) -> "EllKernelOperator":
        scheme = get_scheme(scheme)
        dev = resolve_device(device)
        return cls(
            tile_cols=to_device(m.tile_cols, dev),
            vals=to_device(m.vals, dev, scheme.matrix_dtype),
            local_cols=to_device(m.local_cols, dev),
            diag=to_device(diag, dev, scheme.vector_dtype),
            n=m.shape[0], block_rows=m.block_rows, col_tile=m.col_tile,
            padded_cols=m.padded_cols, scheme=scheme, nnz=m.nnz)

    @property
    def device(self) -> torch.device:
        return self.diag.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        x_pad = torch.zeros(self.padded_cols, dtype=x.dtype, device=x.device)
        x_pad[: self.n] = x
        x_tiles = x_pad.reshape(-1, self.col_tile)
        y = _spmv.spmv_ell(self.tile_cols, self.vals, self.local_cols,
                           x_tiles, scheme=self.scheme)
        return y.reshape(-1)[: self.n].to(self.scheme.vector_dtype)

    def flops_per_matvec(self) -> int:
        return 2 * self.nnz


def _operator_from_csr(a: CSRMatrix, scheme: PrecisionScheme, diag,
                       block_rows: int, col_tile: int,
                       dev: torch.device) -> EllKernelOperator:
    """The operator packed on ``dev`` from the CSR (:mod:`repro_torch
    .kernels.pack`): at the matrix's own dims, the diagonal the kernel's
    unless ``diag`` is given; the same tensors, byte for byte, as
    ``from_ellpack(csr_to_ellpack(a), scheme, a.diagonal())``."""
    csr = _pack.CSRTensors.from_csr(a, dev)
    geom = _pack.ellpack_geometry(csr, block_rows=block_rows,
                                  col_tile=col_tile)
    tile_cols, vals, local_cols, dg = _pack.ellpack_pack(
        csr, geom, geom[:3], block_rows=block_rows, col_tile=col_tile,
        matrix_dtype=scheme.matrix_dtype, vector_dtype=scheme.vector_dtype)
    solver_metrics().count("device_packs")
    n = a.shape[0]
    return EllKernelOperator(
        tile_cols=tile_cols, vals=vals, local_cols=local_cols,
        diag=(dg[:n] if diag is None
              else to_device(diag, dev, scheme.vector_dtype)),
        n=n, block_rows=block_rows, col_tile=col_tile,
        padded_cols=geom[3] * col_tile, scheme=scheme, nnz=a.nnz)


def ell_operator_pallas(a, scheme, *, diag=None, block_rows: int = 256,
                        col_tile: int = 512,
                        device=None) -> EllKernelOperator:
    """Coerce CSR / EllpackMatrix / a dense square array to a kernel-backed
    operator on ``device`` (default ``"cuda"``); a CSR (or dense array) is
    packed on that device, only its arrays copied there."""
    scheme = get_scheme(scheme)
    if isinstance(a, EllKernelOperator):
        return a
    if isinstance(a, CSRMatrix):
        return _operator_from_csr(a, scheme, diag, block_rows, col_tile,
                                  resolve_device(device))
    if isinstance(a, EllpackMatrix):
        if diag is None:
            raise ValueError("EllpackMatrix input requires an explicit diag")
        return EllKernelOperator.from_ellpack(a, scheme, diag, device)
    arr = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if arr.ndim == 2 and arr.shape[0] == arr.shape[1]:
        rows, cols = np.nonzero(arr)
        csr = csr_from_coo(rows, cols, arr[rows, cols], arr.shape)
        return ell_operator_pallas(csr, scheme, diag=diag,
                                   block_rows=block_rows, col_tile=col_tile,
                                   device=device)
    raise TypeError(f"cannot build a kernel operator from {type(a)}")


#: The reference's historical alias.
bell_operator_pallas = ell_operator_pallas


def make_phase_ops():
    """Phase-op triple for :func:`repro_torch.core.phases.jpcg_loop`.

    Returns ``(dot, phase2, phase3)`` where
    ``dot(a, b) -> 0-d``, ``phase2(alpha, r, ap, diag) -> (r', [rr, rz])``
    and ``phase3(alpha, beta, r', diag, p, x) -> (p', x')`` — each one
    kernel launch on the card.
    """

    def dot(a, b):
        return _dot.dot(a, b, acc_dtype=a.dtype)

    return dot, _fused.phase2, _fused.phase3


def make_dot3():
    """Fused triple-dot ``(r, u, w) -> [r·u, w·u, r·r]`` at ``r.dtype``."""

    def dot3(r, u, w):
        return _dot.dot3(r, u, w, acc_dtype=r.dtype)

    return dot3
