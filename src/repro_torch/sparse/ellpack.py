"""Banked ELLPACK layout (a copy of :mod:`repro.sparse.ellpack`).

One row per thread makes the row index *implicit*:

* rows are grouped into **row blocks** of ``block_rows`` (one CUDA block
  of the ELLPACK kernel each);
* the columns a row block touches are grouped into **col tiles** of
  ``col_tile`` (the x tile a slab's local column indices address);
* within a (row-block, col-tile) cell every row stores its nonzeros in
  ``ell`` *slots*; arrays are slot-major ``[B, T, ell, block_rows]`` so
  one slot is a coalesced load across the block's rows;
* ``tile_cols[B, T]`` lists which x tile each slab wants.

Padding entries carry ``val = 0, local_col = 0`` and contribute
``0 * x[tile_base]``.  ``padding_efficiency`` reports the waste.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.precision import host_values
from repro_torch.sparse.csr import CSRMatrix

__all__ = ["EllpackMatrix", "csr_to_ellpack", "ellpack_spmv_reference"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class EllpackMatrix:
    """Slot-major banked ELLPACK (host numpy; device placement at use site)."""

    tile_cols: np.ndarray   # int32[B, T]        x-tile id per slab
    vals: np.ndarray        # v[B, T, ell, R]    slot-major values
    local_cols: np.ndarray  # int32[B, T, ell, R] in [0, col_tile)
    shape: Tuple[int, int]  # logical (unpadded) shape
    block_rows: int
    col_tile: int
    nnz: int

    @property
    def n_row_blocks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def n_slabs(self) -> int:
        return int(self.vals.shape[1])

    @property
    def ell(self) -> int:
        return int(self.vals.shape[2])

    @property
    def padded_rows(self) -> int:
        return self.n_row_blocks * self.block_rows

    @property
    def padded_cols(self) -> int:
        return _round_up(self.shape[1], self.col_tile)

    @property
    def n_col_tiles(self) -> int:
        return self.padded_cols // self.col_tile

    @property
    def stored_entries(self) -> int:
        return int(np.prod(self.vals.shape))

    @property
    def padding_efficiency(self) -> float:
        return self.nnz / max(1, self.stored_entries)

    def astype(self, dtype) -> "EllpackMatrix":
        """Values at a host dtype (:data:`~repro_torch.core.precision
        .BF16_CARRIER`: bf16 bit patterns, rounded as the reference's
        ``astype(jnp.bfloat16)``)."""
        return dataclasses.replace(self, vals=host_values(self.vals, dtype))

    def stream_bytes(self, value_bytes: int | None = None,
                     index_bytes: int = 2) -> int:
        """Bytes one SpMV streams for the matrix operand: a value and one
        local column index per stored entry (rows are implicit)."""
        if value_bytes is None:
            value_bytes = self.vals.dtype.itemsize
        return self.stored_entries * (value_bytes + index_bytes)


def csr_to_ellpack(a: CSRMatrix, *, block_rows: int = 256,
                   col_tile: int = 512) -> EllpackMatrix:
    """Convert CSR to slot-major banked ELLPACK.

    ``block_rows`` is the ELLPACK kernel's CUDA block size (at most 1024)
    and ``col_tile`` the width of the x tile a slab gathers from.
    """
    n_rows, n_cols = a.shape
    B = max(1, -(-n_rows // block_rows))

    row_ids = np.repeat(np.arange(n_rows, dtype=np.int64), a.row_nnz())
    col_ids = a.indices.astype(np.int64)
    blk = row_ids // block_rows
    tile = col_ids // col_tile

    if row_ids.size == 0:
        z = np.zeros((B, 1, 1, block_rows), dtype=a.data.dtype)
        zi = np.zeros((B, 1, 1, block_rows), dtype=np.int32)
        return EllpackMatrix(np.zeros((B, 1), np.int32), z, zi, a.shape,
                             block_rows, col_tile, 0)

    # CSR order is already (row, col) sorted -> (blk, tile) groups are
    # contiguous per row; sort globally by (blk, tile, row).
    order = np.lexsort((row_ids, tile, blk))
    blk_s, tile_s, row_s = blk[order], tile[order], row_ids[order]
    lcol_s = (col_ids[order] - tile_s * col_tile).astype(np.int32)
    vals_s = a.data[order]
    lrow_s = (row_s - blk_s * block_rows).astype(np.int32)

    # Slab id: rank of this (blk, tile) cell among the block's cells.
    cell_change = np.empty(blk_s.shape[0], dtype=bool)
    cell_change[0] = True
    cell_change[1:] = (blk_s[1:] != blk_s[:-1]) | (tile_s[1:] != tile_s[:-1])
    cell_id = np.cumsum(cell_change) - 1
    cell_blk = blk_s[cell_change]
    cell_tile = tile_s[cell_change]
    blk_change = np.empty(cell_blk.shape[0], dtype=bool)
    blk_change[0] = True
    blk_change[1:] = cell_blk[1:] != cell_blk[:-1]
    first_cell_of_blk = np.maximum.accumulate(
        np.where(blk_change, np.arange(cell_blk.size), 0))
    cell_slot = np.arange(cell_blk.size) - first_cell_of_blk
    T = int(cell_slot.max()) + 1

    # Slot of each nonzero within its (cell, row): rank among same-row
    # entries of the cell.  Entries are sorted by (cell, row), so:
    rowkey_change = cell_change | np.concatenate(
        [[True], row_s[1:] != row_s[:-1]])
    idx = np.arange(blk_s.shape[0])
    run_start = np.maximum.accumulate(np.where(rowkey_change, idx, 0))
    slot = idx - run_start
    ell = int(slot.max()) + 1

    tile_cols = np.zeros((B, T), dtype=np.int32)
    tile_cols[cell_blk, cell_slot] = cell_tile.astype(np.int32)
    vals = np.zeros((B, T, ell, block_rows), dtype=a.data.dtype)
    lcols = np.zeros((B, T, ell, block_rows), dtype=np.int32)
    s_of_nz = cell_slot[cell_id]
    vals[blk_s, s_of_nz, slot, lrow_s] = vals_s
    lcols[blk_s, s_of_nz, slot, lrow_s] = lcol_s

    return EllpackMatrix(tile_cols, vals, lcols, a.shape, block_rows,
                         col_tile, a.nnz)


def ellpack_spmv_reference(m: EllpackMatrix, x: np.ndarray,
                           out_dtype=np.float64) -> np.ndarray:
    """Golden numpy SpMV over the ELLPACK layout (kernel dataflow order)."""
    x_pad = np.zeros(m.padded_cols, dtype=out_dtype)
    x_pad[: x.shape[0]] = x.astype(out_dtype)
    y = np.zeros(m.padded_rows, dtype=out_dtype)
    R, C = m.block_rows, m.col_tile
    for i in range(m.n_row_blocks):
        acc = np.zeros(R, dtype=out_dtype)
        for t in range(m.n_slabs):
            xt = x_pad[int(m.tile_cols[i, t]) * C:][:C]
            for e in range(m.ell):
                acc += (m.vals[i, t, e].astype(out_dtype)
                        * xt[m.local_cols[i, t, e]])
        y[i * R:(i + 1) * R] = acc
    return y[: m.shape[0]]
