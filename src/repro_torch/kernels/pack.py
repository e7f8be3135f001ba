"""CSR to banked, slot-major ELLPACK on the device, beside its plain
PyTorch version.

The layout is :mod:`repro_torch.sparse.ellpack`'s; the host's
``pad_ellpack(csr_to_ellpack(a), ...)`` with its values copied to the
scheme's matrix dtype, and ``a.diagonal()`` padded with ones at the
vector dtype, are what these functions write, byte for byte.  They serve
the ELLPACK pools of :class:`repro_torch.serve.SolverEngine` (each
admission) and :func:`repro_torch.kernels.ops.ell_operator_pallas` (the
single-system operator build), so only the CSR crosses the bus:

* :meth:`CSRTensors.from_csr` copies the CSR's three arrays to a device;
* :func:`ellpack_geometry` returns ``(n_row_blocks, n_slabs, ell,
  n_col_tiles)``: what ``csr_to_ellpack`` would make of it (on the card
  one small device-to-host read, of ``(n_slabs, ell)``);
* :func:`ellpack_pack` writes a lane of dims at least those (the pool's
  bucket, or the matrix's own): ``tile_cols``, ``vals``, ``local_cols``
  and the diagonal, every element of each, into given tensors or new ones.

On the card both are ``csrc/ellpack_pack.cu``.  It replaces no TPU
kernel (the JAX package packs on the host); see the source for its
design and bound.  A slot holds the e-th entry of its row in its slab's
tile, in CSR order, as the host's stable sort places it: unsorted
columns and duplicate entries land where the host puts them.  Values
round from fp64 as the host path's CPU casts round them (bf16 through
its bits, :func:`repro_torch.core.precision.bf16_bits`).

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  :data:`LAUNCHES` counts the
launches of each kernel (read with the port's others through
:func:`repro_torch.kernels.ops.launches`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.metrics import traced_metrics
from repro_torch.kernels._launch import (I, LL, P, check_cuda, function,
                                         on_cpu, raise_on_error)
from repro_torch.sparse.csr import CSRMatrix

__all__ = ["CSRTensors", "ellpack_geometry", "ellpack_geometry_plain",
           "ellpack_pack", "ellpack_pack_plain", "LAUNCHES",
           "reset_launches"]

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"ellpack_geometry": 0, "ellpack_scatter": 0}

_MATRIX_CODE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
_VECTOR_CODE = {torch.float64: 0, torch.float32: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class CSRTensors:
    """A CSR matrix on a device: ``indptr`` int64[n_rows + 1], ``indices``
    int32[nnz], ``data`` float64[nnz]."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: Tuple[int, int]

    @classmethod
    def from_csr(cls, a: CSRMatrix, device) -> "CSRTensors":
        """``a``'s arrays on ``device``, one copy each (values widened to
        fp64 on the host first, which is exact for float values)."""
        arrays = (np.ascontiguousarray(a.indptr, np.int64),
                  np.ascontiguousarray(a.indices, np.int32),
                  np.ascontiguousarray(a.data, np.float64))
        return cls(*(torch.from_numpy(x).to(device) for x in arrays),
                   shape=tuple(a.shape))

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.indptr, self.indices, self.data))


def _n_row_blocks(n_rows: int, block_rows: int) -> int:
    return max(1, -(-n_rows // block_rows))


def _check_blocking(name: str, block_rows: int, col_tile: int) -> None:
    if not 1 <= block_rows <= 1024 or col_tile < 1:
        raise ValueError(f"{name}: block_rows {block_rows} must lie in "
                         f"[1, 1024] and col_tile {col_tile} be positive")


def _row_ids(csr: CSRTensors) -> torch.Tensor:
    counts = csr.indptr[1:] - csr.indptr[:-1]
    return torch.repeat_interleave(
        torch.arange(csr.shape[0], device=counts.device), counts)


# ---------------------------------------------------------------- geometry
def ellpack_geometry_plain(csr: CSRTensors, *, block_rows: int = 256,
                           col_tile: int = 512) -> Tuple[int, int, int, int]:
    """``(n_row_blocks, n_slabs, ell, n_col_tiles)`` of
    ``csr_to_ellpack(a, block_rows=, col_tile=)``."""
    n_rows, n_cols = csr.shape
    B = _n_row_blocks(n_rows, block_rows)
    n_ct = -(-n_cols // col_tile)
    if csr.nnz == 0:
        return B, 1, 1, n_ct
    row = _row_ids(csr)
    tile = csr.indices.long() // col_tile
    span = int(tile.max()) + 1
    cells = torch.unique(row // block_rows * span + tile)
    T = int(torch.bincount(cells // span).max())
    ell = int(torch.unique(row * span + tile, return_counts=True)[1].max())
    return B, T, ell, n_ct


def ellpack_geometry(csr: CSRTensors, *, block_rows: int = 256,
                     col_tile: int = 512) -> Tuple[int, int, int, int]:
    """``(n_row_blocks, n_slabs, ell, n_col_tiles)`` of the CSR's banked
    ELLPACK form, as host ints.  On the card the geometry pass runs and
    its two ints are read back: one blocking read, counted in the traced
    ``host_syncs`` of the innermost open span's bag."""
    _check_blocking("ellpack_geometry", block_rows, col_tile)
    if on_cpu("ellpack_geometry", csr.indices):
        return ellpack_geometry_plain(csr, block_rows=block_rows,
                                      col_tile=col_tile)
    dev = csr.indices.device
    check_cuda("ellpack_geometry", dev, indptr=csr.indptr,
               indices=csr.indices)
    n_rows, n_cols = csr.shape
    B = _n_row_blocks(n_rows, block_rows)
    out = torch.zeros(2, dtype=torch.int32, device=dev)
    fn = function("ellpack_pack", "repro_ellpack_geometry",
                  [P, P, LL, I, I, I, P, P])
    with torch.cuda.device(dev):
        err = fn(csr.indptr.data_ptr(), csr.indices.data_ptr(), n_rows,
                 block_rows, col_tile, B, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    raise_on_error("ellpack_pack", "ellpack_geometry", err)
    LAUNCHES["ellpack_geometry"] += 1
    T, ell = (max(1, int(v)) for v in out.tolist())
    traced_metrics().count("host_syncs")
    return B, T, ell, -(-n_cols // col_tile)


# -------------------------------------------------------------------- pack
def _bf16(v: torch.Tensor) -> torch.Tensor:
    """fp64 values rounded to bf16 as :func:`repro_torch.core.precision
    .bf16_bits` rounds them: to fp32, then to nearest even on the 16
    dropped bits; a NaN keeps its fp32 bits' top half, made quiet."""
    u = v.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(torch.isnan(v), (u >> 16) | 0x40,
                       (u + 0x7FFF + ((u >> 16) & 1)) >> 16)
    bits = bits - (bits >= 0x8000).to(torch.int64) * 0x10000
    return bits.to(torch.int16).view(torch.bfloat16)


def _as_dtype(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return _bf16(v) if dtype == torch.bfloat16 else v.to(dtype)


def _lane(dims: Tuple[int, int, int], block_rows: int, matrix_dtype,
          vector_dtype, device, out: Optional[Sequence[torch.Tensor]]):
    B, T, L = dims
    shapes = ((B, T), (B, T, L, block_rows), (B, T, L, block_rows),
              (B * block_rows,))
    dtypes = (torch.int32, matrix_dtype, torch.int32, vector_dtype)
    if out is None:
        return tuple(torch.empty(s, dtype=d, device=device)
                     for s, d in zip(shapes, dtypes))
    out = tuple(out)
    for name, t, s, d in zip(("tile_cols", "vals", "local_cols", "diag"),
                             out, shapes, dtypes):
        if tuple(t.shape) != s or t.dtype != d or t.device != device:
            raise ValueError(
                f"ellpack_pack: {name} is {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, want {s} {d} on {device}")
    return out


def _check_dims(geometry, dims) -> None:
    B, T, L, _ = geometry
    if len(dims) != 3 or dims[0] < B or dims[1] < T or dims[2] < L:
        raise ValueError(
            f"ellpack_pack: dims {tuple(dims)} do not hold the geometry "
            f"(n_row_blocks, n_slabs, ell) = {(B, T, L)}")


def ellpack_pack_plain(csr: CSRTensors, geometry, dims, *,
                       block_rows: int = 256, col_tile: int = 512,
                       matrix_dtype=torch.float32,
                       vector_dtype=torch.float64, out=None) -> tuple:
    """``(tile_cols, vals, local_cols, diag)``: ``pad_ellpack(
    csr_to_ellpack(a), ...)`` at ``dims = (B, T, L)``, its values at
    ``matrix_dtype``, and ``a.diagonal()`` at ``vector_dtype`` padded with
    ones to ``B * block_rows`` (the last entry of a duplicated diagonal)."""
    _check_blocking("ellpack_pack", block_rows, col_tile)
    _check_dims(geometry, dims)
    tile_cols, vals, local_cols, diag = _lane(
        dims, block_rows, matrix_dtype, vector_dtype, csr.data.device, out)
    for t in (tile_cols, vals, local_cols):
        t.zero_()
    diag.fill_(1.0)
    n_rows = csr.shape[0]
    if csr.nnz == 0:
        diag[:n_rows] = 0.0
        return tile_cols, vals, local_cols, diag
    R, C = block_rows, col_tile
    row = _row_ids(csr)
    col = csr.indices.long()
    tile = col // C
    blk = row // R
    lrow = row - blk * R
    span = int(tile.max()) + 1
    cell = blk * span + tile
    # (block, tile, row) order, CSR order within: the host's stable lexsort
    order = torch.sort(cell * R + lrow, stable=True).indices
    cell_s, key_s = cell[order], (cell * R + lrow)[order]
    ucell = torch.unique_consecutive(cell_s)
    ublk = ucell // span
    slab_of_cell = (torch.arange(ucell.numel(), device=ucell.device)
                    - torch.searchsorted(ublk, ublk))
    slab = slab_of_cell[torch.searchsorted(ucell, cell_s)]
    # slot: rank among the row's entries in the tile
    pos = torch.arange(order.numel(), device=order.device)
    start = torch.ones_like(key_s, dtype=torch.bool)
    start[1:] = key_s[1:] != key_s[:-1]
    slot = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    tile_cols[ublk, slab_of_cell] = (ucell - ublk * span).to(torch.int32)
    where = (blk[order], slab, slot, lrow[order])
    vals[where] = _as_dtype(csr.data[order], matrix_dtype)
    local_cols[where] = (col - tile * C)[order].to(torch.int32)
    # the diagonal: the last entry at (i, i) in CSR order, else 0
    on_diag = torch.nonzero(col == row).reshape(-1)
    last = torch.full((n_rows,), -1, dtype=torch.int64, device=row.device)
    last.scatter_reduce_(0, row[on_diag], on_diag, "amax")
    dg = torch.where(last >= 0, csr.data[last.clamp(min=0)],
                     torch.zeros((), dtype=torch.float64, device=row.device))
    diag[:n_rows] = _as_dtype(dg, vector_dtype)
    return tile_cols, vals, local_cols, diag


def ellpack_pack(csr: CSRTensors, geometry, dims, *, block_rows: int = 256,
                 col_tile: int = 512, matrix_dtype=torch.float32,
                 vector_dtype=torch.float64, out=None) -> tuple:
    """Write a banked ELLPACK lane of ``dims = (B, T, L)`` (at least
    ``geometry[:3]``, :func:`ellpack_geometry`'s) and its diagonal:
    ``(tile_cols int32[B, T], vals matrix_dtype[B, T, L, block_rows],
    local_cols int32[B, T, L, block_rows], diag vector_dtype[B *
    block_rows])``, into ``out`` (four contiguous tensors of those shapes,
    such as a slot of a stacked pool) or new tensors.  Every element is
    written."""
    _check_blocking("ellpack_pack", block_rows, col_tile)
    if on_cpu("ellpack_pack", csr.indices):
        return ellpack_pack_plain(csr, geometry, dims,
                                  block_rows=block_rows, col_tile=col_tile,
                                  matrix_dtype=matrix_dtype,
                                  vector_dtype=vector_dtype, out=out)
    _check_dims(geometry, dims)
    if matrix_dtype not in _MATRIX_CODE or vector_dtype not in _VECTOR_CODE:
        raise ValueError(f"ellpack_pack: no kernel for values at "
                         f"{matrix_dtype} and a diagonal at {vector_dtype}")
    dev = csr.indices.device
    lane = _lane(dims, block_rows, matrix_dtype, vector_dtype, dev, out)
    tile_cols, vals, local_cols, diag = lane
    check_cuda("ellpack_pack", dev, indptr=csr.indptr, indices=csr.indices,
               data=csr.data, tile_cols=tile_cols, vals=vals,
               local_cols=local_cols, diag=diag)
    B, T, L = dims
    fn = function("ellpack_pack", "repro_ellpack_scatter",
                  [I, I, P, P, P, LL, I, I, I, I, I, P, P, P, P, P])
    with torch.cuda.device(dev):
        err = fn(_MATRIX_CODE[matrix_dtype], _VECTOR_CODE[vector_dtype],
                 csr.indptr.data_ptr(), csr.indices.data_ptr(),
                 csr.data.data_ptr(), csr.shape[0], block_rows, col_tile,
                 B, T, L, tile_cols.data_ptr(), vals.data_ptr(),
                 local_cols.data_ptr(), diag.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    raise_on_error("ellpack_pack", "ellpack_scatter", err)
    LAUNCHES["ellpack_scatter"] += 1
    return lane
