"""Linear operators consumed by the single-system JPCG solver (the port of
:mod:`repro.core.operators`).

Every operator exposes ``matvec`` (the SpMV, with the precision scheme's
casts applied *inside*), ``diag`` (Jacobi preconditioner source), ``n``
and ``device``; its tensors live on one explicit device.

* :class:`BellOperator` — banked-ELL sparse matrix on the device, SpMV in
  plain PyTorch (:func:`bell_spmv_torch`, the ``backend="xla"`` path).
* :class:`DenseOperator` — small dense SPD matrices (tests).
* :class:`CallableOperator` — matrix-free.

Mixed-precision contract (paper §6): the operator *stores* A at
``scheme.matrix_dtype``; ``matvec`` casts the incoming vector to
``scheme.spmv_in_dtype`` (a true rounding — this is where Mix-V1/V2 lose
information), multiplies/accumulates at ``scheme.spmv_acc_dtype``, and
returns at ``scheme.vector_dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.precision import PrecisionScheme, get_scheme
from repro_torch.device import resolve_device, to_device
from repro_torch.sparse.bell import BellMatrix, csr_to_bell
from repro_torch.sparse.csr import CSRMatrix

__all__ = ["BellOperator", "DenseOperator", "CallableOperator", "as_operator",
           "bell_spmv_torch"]


def bell_spmv_torch(tile_cols: torch.Tensor, vals: torch.Tensor,
                    local_rows: torch.Tensor, local_cols: torch.Tensor,
                    x_pad: torch.Tensor, *, block_rows: int, col_tile: int,
                    scheme: PrecisionScheme) -> torch.Tensor:
    """Banked-ELL SpMV in plain PyTorch (the port of ``bell_spmv_jnp``).

    ``x_pad`` has length ``n_col_tiles * col_tile``; returns a vector of
    length ``n_row_blocks * block_rows`` at ``scheme.vector_dtype``.  The
    reference's ``segment_sum`` becomes ``index_put_`` with
    ``accumulate=True``.  On a CUDA device that sorts the row indices and
    sums each row's products in a fixed order, so the result is the same on
    every run; ``index_add_`` adds there with atomics in no fixed order, and
    a solve through it may end an iteration or two earlier or later from
    one run to the next.
    """
    B, T, L = vals.shape
    acc = scheme.spmv_acc_dtype
    x_in = x_pad.to(scheme.spmv_in_dtype)               # the Mix-V1/V2 rounding
    cols = tile_cols.long()[:, :, None] * col_tile + local_cols.long()
    prod = vals.to(acc) * x_in[cols].to(acc)            # [B, T, L]
    seg = (torch.arange(B, device=vals.device)[:, None, None] * block_rows
           + local_rows.long()).reshape(-1)
    y = torch.zeros(B * block_rows, dtype=acc, device=vals.device)
    y.index_put_((seg,), prod.reshape(-1), accumulate=True)
    return y.to(scheme.vector_dtype)


@dataclasses.dataclass(frozen=True)
class BellOperator:
    """Banked-ELL matrix resident on a device at the scheme's matrix dtype."""

    tile_cols: torch.Tensor   # int32[B, T]
    vals: torch.Tensor        # matrix_dtype[B, T, L]
    local_rows: torch.Tensor  # int32[B, T, L]
    local_cols: torch.Tensor  # int32[B, T, L]
    diag: torch.Tensor        # vector_dtype[n]
    n: int
    block_rows: int
    col_tile: int
    padded_cols: int
    scheme: PrecisionScheme
    nnz: int

    @classmethod
    def from_bell(cls, m: BellMatrix, scheme, diag,
                  device=None) -> "BellOperator":
        scheme = get_scheme(scheme)
        dev = resolve_device(device)
        return cls(
            tile_cols=to_device(m.tile_cols, dev),
            vals=to_device(m.vals, dev, scheme.matrix_dtype),
            local_rows=to_device(m.local_rows, dev),
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
        y = bell_spmv_torch(self.tile_cols, self.vals, self.local_rows,
                            self.local_cols, x_pad,
                            block_rows=self.block_rows,
                            col_tile=self.col_tile, scheme=self.scheme)
        return y[: self.n]

    def flops_per_matvec(self) -> int:
        return 2 * self.nnz


@dataclasses.dataclass(frozen=True)
class DenseOperator:
    a: torch.Tensor           # matrix_dtype[n, n]
    diag: torch.Tensor        # vector_dtype[n]
    scheme: PrecisionScheme

    @classmethod
    def from_dense(cls, a, scheme, device=None) -> "DenseOperator":
        scheme = get_scheme(scheme)
        dev = resolve_device(device)
        a = np.asarray(a)
        return cls(a=to_device(a, dev, scheme.matrix_dtype),
                   diag=to_device(np.diag(a), dev, scheme.vector_dtype),
                   scheme=scheme)

    @property
    def n(self) -> int:
        return int(self.a.shape[0])

    @property
    def device(self) -> torch.device:
        return self.diag.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        acc = self.scheme.spmv_acc_dtype
        x_in = x.to(self.scheme.spmv_in_dtype)
        y = self.a.to(acc) @ x_in.to(acc)
        return y.to(self.scheme.vector_dtype)

    def flops_per_matvec(self) -> int:
        return 2 * self.n * self.n


@dataclasses.dataclass(frozen=True)
class CallableOperator:
    """Matrix-free operator: ``fn`` maps an ``spmv_in_dtype`` vector on
    ``device`` to a vector the operator returns at ``vector_dtype``."""

    fn: Callable[[torch.Tensor], torch.Tensor]
    diag: torch.Tensor
    n: int
    scheme: PrecisionScheme

    @property
    def device(self) -> torch.device:
        return self.diag.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        x_in = x.to(self.scheme.spmv_in_dtype)
        return self.fn(x_in).to(self.scheme.vector_dtype)

    def flops_per_matvec(self) -> int:
        return 0  # unknown for matrix-free


def as_operator(a, scheme, *, diag=None, n=None, block_rows: int = 256,
                col_tile: int = 512, device=None):
    """Coerce a CSRMatrix / BellMatrix / dense array / callable to an
    operator on ``device`` (default ``"cuda"``); an operator is returned
    as it is."""
    scheme = get_scheme(scheme)
    if isinstance(a, (BellOperator, DenseOperator, CallableOperator)):
        return a
    if isinstance(a, CSRMatrix):
        d = a.diagonal() if diag is None else diag
        bell = csr_to_bell(a, block_rows=block_rows, col_tile=col_tile)
        return BellOperator.from_bell(bell, scheme, d, device)
    if isinstance(a, BellMatrix):
        if diag is None:
            raise ValueError("BellMatrix input requires an explicit diag")
        return BellOperator.from_bell(a, scheme, diag, device)
    if callable(a):
        if diag is None or n is None:
            raise ValueError("callable operator requires diag and n")
        return CallableOperator(fn=a, diag=to_device(
            diag, resolve_device(device), scheme.vector_dtype), n=n,
            scheme=scheme)
    arr = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if arr.ndim == 2:
        return DenseOperator.from_dense(arr, scheme, device)
    raise TypeError(f"cannot build an operator from {type(a)}")
