"""Banked-ELL ("streams") sparse format (a copy of :mod:`repro.sparse.bell`).

The layout behind the single-system solver's ``backend="xla"`` operator
(:class:`repro_torch.core.operators.BellOperator`):

* rows are grouped into **row blocks** of ``block_rows`` and columns into
  **col tiles** of ``col_tile``;
* the nonzeros of each (row-block, col-tile) cell form a **slab**, padded
  to a fixed ``slab_len``, with indices stored relative to the block/tile
  base;
* each row block lists the col tiles it touches (``tile_cols``).

Dummy (padding) entries have ``val = 0`` and local indices ``0`` so they
contribute ``0 * x[tile_base]`` to row ``block_base`` — harmless.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.sparse.csr import CSRMatrix

__all__ = ["BellMatrix", "csr_to_bell", "bell_spmv_reference"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BellMatrix:
    """Banked-ELL matrix (host numpy arrays; device placement at use site)."""

    tile_cols: np.ndarray   # int32[n_row_blocks, n_slabs]  col-tile id per slab
    vals: np.ndarray        # v[n_row_blocks, n_slabs, slab_len]
    local_rows: np.ndarray  # int32[same] in [0, block_rows)
    local_cols: np.ndarray  # int32[same] in [0, col_tile)
    shape: Tuple[int, int]  # logical (unpadded) shape
    block_rows: int
    col_tile: int
    nnz: int                # true nonzeros (excludes padding)

    @property
    def n_row_blocks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def n_slabs(self) -> int:
        return int(self.vals.shape[1])

    @property
    def slab_len(self) -> int:
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
        """nnz / stored entries — 1.0 means zero padding waste."""
        return self.nnz / max(1, self.stored_entries)

    def astype(self, dtype) -> "BellMatrix":
        return dataclasses.replace(self, vals=self.vals.astype(dtype))

    def stream_bytes(self, value_bytes: int | None = None, index_bytes: int = 2) -> int:
        """HBM bytes one SpMV streams for the matrix operand.

        Serpens packs (col, row, val) in 8 bytes; our slab entry is
        ``value_bytes + 2 * index_bytes`` (local indices fit int16 whenever
        block_rows, col_tile <= 32768, which is always true here).
        """
        if value_bytes is None:
            value_bytes = self.vals.dtype.itemsize
        return self.stored_entries * (value_bytes + 2 * index_bytes)


def csr_to_bell(a: CSRMatrix, *, block_rows: int = 256, col_tile: int = 512,
                pad_slab_to: int = 8) -> BellMatrix:
    """Convert CSR to banked-ELL.

    Any positive ``block_rows`` and ``col_tile`` work: the banked-ELL
    operator's SpMV is plain PyTorch (no kernel constrains the tiles).
    """
    n_rows, n_cols = a.shape
    n_row_blocks = max(1, -(-n_rows // block_rows))

    row_ids = np.repeat(np.arange(n_rows, dtype=np.int64), a.row_nnz())
    col_ids = a.indices.astype(np.int64)
    blk = row_ids // block_rows
    tile = col_ids // col_tile

    # Sort nonzeros by (row block, col tile); stable keeps row-major order
    # inside a slab, which mirrors the paper's in-stream ordering.
    order = np.lexsort((row_ids, tile, blk))
    blk_s, tile_s = blk[order], tile[order]
    lrow_s = (row_ids[order] - blk_s * block_rows).astype(np.int32)
    lcol_s = (col_ids[order] - tile_s * col_tile).astype(np.int32)
    vals_s = a.data[order]

    if blk_s.size == 0:
        n_slabs, slab_len = 1, pad_slab_to
        tile_cols = np.zeros((n_row_blocks, n_slabs), dtype=np.int32)
        z = np.zeros((n_row_blocks, n_slabs, slab_len), dtype=a.data.dtype)
        zi = np.zeros((n_row_blocks, n_slabs, slab_len), dtype=np.int32)
        return BellMatrix(tile_cols, z, zi, zi.copy(), a.shape, block_rows, col_tile, 0)

    # Group boundaries over (blk, tile) pairs.
    key_change = np.empty(blk_s.shape[0], dtype=bool)
    key_change[0] = True
    key_change[1:] = (blk_s[1:] != blk_s[:-1]) | (tile_s[1:] != tile_s[:-1])
    group = np.cumsum(key_change) - 1                     # group id per nnz
    g_start = np.flatnonzero(key_change)
    g_count = np.diff(np.append(g_start, blk_s.shape[0]))
    g_blk = blk_s[g_start]
    g_tile = tile_s[g_start]

    # Slab slot of each group within its row block (rank of tile in block).
    blk_change = np.empty(g_blk.shape[0], dtype=bool)
    blk_change[0] = True
    blk_change[1:] = g_blk[1:] != g_blk[:-1]
    first_group_of_blk = np.maximum.accumulate(np.where(blk_change, np.arange(g_blk.size), 0))
    g_slot = np.arange(g_blk.size) - first_group_of_blk

    n_slabs = int(g_slot.max()) + 1
    slab_len = _round_up(int(g_count.max()), pad_slab_to)

    tile_cols = np.zeros((n_row_blocks, n_slabs), dtype=np.int32)
    vals = np.zeros((n_row_blocks, n_slabs, slab_len), dtype=a.data.dtype)
    local_rows = np.zeros((n_row_blocks, n_slabs, slab_len), dtype=np.int32)
    local_cols = np.zeros((n_row_blocks, n_slabs, slab_len), dtype=np.int32)

    tile_cols[g_blk, g_slot] = g_tile.astype(np.int32)
    # Position of each nonzero within its slab.
    pos_in_group = np.arange(blk_s.shape[0]) - g_start[group]
    vals[blk_s, g_slot[group], pos_in_group] = vals_s
    local_rows[blk_s, g_slot[group], pos_in_group] = lrow_s
    local_cols[blk_s, g_slot[group], pos_in_group] = lcol_s

    return BellMatrix(tile_cols, vals, local_rows, local_cols,
                      a.shape, block_rows, col_tile, a.nnz)


def bell_spmv_reference(m: BellMatrix, x: np.ndarray,
                        out_dtype=np.float64) -> np.ndarray:
    """Golden numpy SpMV over the banked-ELL layout (slab accumulation order).

    Matches the kernel's dataflow: for each (row block, slab): gather the
    x col-tile, multiply by slab values, scatter-add to the y row block.
    """
    x_pad = np.zeros(m.padded_cols, dtype=out_dtype)
    x_pad[: x.shape[0]] = x.astype(out_dtype)
    y = np.zeros(m.padded_rows, dtype=out_dtype)
    C, R = m.col_tile, m.block_rows
    for i in range(m.n_row_blocks):
        for t in range(m.n_slabs):
            base = int(m.tile_cols[i, t]) * C
            xt = x_pad[base: base + C]
            prod = m.vals[i, t].astype(out_dtype) * xt[m.local_cols[i, t]]
            np.add.at(y, i * R + m.local_rows[i, t], prod)
    return y[: m.shape[0]]
