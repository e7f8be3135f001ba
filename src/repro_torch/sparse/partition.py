"""Row-block partitioning of sparse matrices for the row-distributed CG
(a numpy copy of :mod:`repro.sparse.partition`, byte for byte the same
arrays).

The distributed SpMV is 1-D row-partitioned (the standard decomposition for
CG: every vector op is then purely local except the dot products, which are
single-scalar all-reduces).  Each shard receives an equal-shaped banked-ELL
slice, stacked on a leading shard axis; rank k of
:mod:`repro_torch.distributed.cg_dist` takes slice k.

Column handling: shards reference *global* column tiles; the SpMV gathers
from an all-gathered (or halo-exchanged) x.  For stencil-class matrices the
column span of a shard is a narrow window — ``halo_width`` reports it so the
distributed layer can choose a halo exchange with the two neighbours over
the all-gather.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.sparse.bell import BellMatrix, csr_to_bell
from repro_torch.sparse.csr import CSRMatrix

__all__ = ["partition_rows", "PartitionedMatrix"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class PartitionedMatrix:
    """Equal-shaped BELL shards stacked on a leading shard axis."""

    tile_cols: np.ndarray    # int32[S, B, T]
    vals: np.ndarray         # v[S, B, T, L]
    local_rows: np.ndarray   # int32[S, B, T, L]
    local_cols: np.ndarray   # int32[S, B, T, L]
    shape: Tuple[int, int]   # global logical shape
    rows_per_shard: int      # padded rows each shard owns
    block_rows: int
    col_tile: int
    nnz: int
    halo_width: int          # max |col - row-window| over shards (for stencils)

    # ---- neighbor-halo exchange (stencil fast path) --------------------
    @property
    def halo_pad(self) -> int:
        """Halo rounded up to a whole number of col tiles."""
        return -(-self.halo_width // self.col_tile) * self.col_tile

    @property
    def supports_halo(self) -> bool:
        """One-hop halo: window fits in the two adjacent shards and tile
        alignment holds (col_tile | rows_per_shard)."""
        return (self.halo_width > 0
                and self.halo_pad <= self.rows_per_shard
                and self.rows_per_shard % self.col_tile == 0)

    def tile_cols_halo(self) -> np.ndarray:
        """Per-shard tile ids remapped into the local halo window
        ``[k·R − halo_pad, (k+1)·R + halo_pad)`` — the collective drops
        from an all-gather of x to two neighbor permutes.  Padding slabs
        (zero values) clamp into range; their 0-valued entries contribute
        nothing wherever they read."""
        S = self.n_shards
        C = self.col_tile
        w_tiles = (self.rows_per_shard + 2 * self.halo_pad) // C
        out = np.zeros_like(self.tile_cols)
        for k in range(S):
            ws = (k * self.rows_per_shard - self.halo_pad) // C
            out[k] = np.clip(self.tile_cols[k] - ws, 0, w_tiles - 1)
        return out

    @property
    def n_shards(self) -> int:
        return int(self.vals.shape[0])

    @property
    def padded_rows(self) -> int:
        return self.n_shards * self.rows_per_shard

    @property
    def padded_cols(self) -> int:
        return _round_up(self.shape[1], self.col_tile)

    def shard(self, k: int) -> BellMatrix:
        return BellMatrix(self.tile_cols[k], self.vals[k], self.local_rows[k],
                          self.local_cols[k],
                          (self.rows_per_shard, self.shape[1]),
                          self.block_rows, self.col_tile, -1)


def partition_rows(a: CSRMatrix, n_shards: int, *, block_rows: int = 256,
                   col_tile: int = 512, pad_slab_to: int = 8) -> PartitionedMatrix:
    """Split ``a`` into ``n_shards`` equal row slices, BELL-encode each,
    and pad all shards to a common (n_slabs, slab_len)."""
    n_rows, n_cols = a.shape
    rows_per_shard = _round_up(-(-n_rows // n_shards), block_rows)

    shards: List[BellMatrix] = []
    halo = 0
    for k in range(n_shards):
        r0 = k * rows_per_shard
        r1 = min(n_rows, (k + 1) * rows_per_shard)
        if r0 >= n_rows:
            # Empty shard (padding at the tail of the shard axis).
            indptr = np.zeros(rows_per_shard + 1, dtype=np.int64)
            sl = CSRMatrix(indptr, np.zeros(0, np.int32),
                           np.zeros(0, a.data.dtype), (rows_per_shard, n_cols))
        else:
            lo, hi = a.indptr[r0], a.indptr[r1]
            indptr = np.zeros(rows_per_shard + 1, dtype=np.int64)
            indptr[: r1 - r0 + 1] = a.indptr[r0: r1 + 1] - lo
            indptr[r1 - r0 + 1:] = indptr[r1 - r0]
            sl = CSRMatrix(indptr, a.indices[lo:hi], a.data[lo:hi],
                           (rows_per_shard, n_cols))
            if hi > lo:
                cols = a.indices[lo:hi].astype(np.int64)
                halo = max(halo, int(max(r0 - cols.min(), cols.max() - (r1 - 1), 0)))
        shards.append(csr_to_bell(sl, block_rows=block_rows, col_tile=col_tile,
                                  pad_slab_to=pad_slab_to))

    n_slabs = max(s.n_slabs for s in shards)
    slab_len = max(s.slab_len for s in shards)
    B = rows_per_shard // block_rows

    def pad(arr: np.ndarray, dt) -> np.ndarray:
        out = np.zeros((B, n_slabs, slab_len), dtype=dt)
        out[:, : arr.shape[1], : arr.shape[2]] = arr
        return out

    tile_cols = np.zeros((n_shards, B, n_slabs), dtype=np.int32)
    vals = np.zeros((n_shards, B, n_slabs, slab_len), dtype=a.data.dtype)
    lrows = np.zeros((n_shards, B, n_slabs, slab_len), dtype=np.int32)
    lcols = np.zeros((n_shards, B, n_slabs, slab_len), dtype=np.int32)
    for k, s in enumerate(shards):
        tile_cols[k, :, : s.n_slabs] = s.tile_cols
        vals[k] = pad(s.vals, a.data.dtype)
        lrows[k] = pad(s.local_rows, np.int32)
        lcols[k] = pad(s.local_cols, np.int32)

    return PartitionedMatrix(tile_cols, vals, lrows, lcols, a.shape,
                             rows_per_shard, block_rows, col_tile, a.nnz, halo)
