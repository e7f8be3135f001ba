"""Batched padding / stacking of sparse layouts (a copy of
:mod:`repro.sparse.stacking`).

The batched JPCG engine (:mod:`repro_torch.core.batch`) solves B
independent systems in one masked loop, so every lane's matrix shares one
padded shape.  Each structural dimension is **bucketed** (rounded up to
the next power of two) so heterogeneous traffic collapses onto a handful
of shapes, then **zero-padded + stacked** along a new leading batch axis.

Padded slots carry ``val = 0``; row-ELL and sliced-ELL padding
*self-gathers* (column = own row), ELLPACK padding reads local column 0.
Padded *rows* get a unit diagonal and zero rhs from the caller, so their
residual is identically zero and they never influence termination.
Values are packed at ``scheme.host_matrix_dtype`` (numpy; bf16 as its
``uint16`` bits, rounded as the reference's ``astype(jnp.bfloat16)``),
indices at :func:`index_dtype`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.precision import host_values
from repro_torch.sparse.bell import BellMatrix
from repro_torch.sparse.ellpack import EllpackMatrix

__all__ = ["bucket_up", "lane_bucket_up", "pad_bell", "stack_bell",
           "pad_ellpack", "stack_ellpack", "flatten_bell", "stack_flat",
           "csr_rowell", "stack_rowell", "stack_sell", "StackedBell",
           "StackedEllpack", "StackedFlat", "StackedRowEll", "StackedSell",
           "sell_slice_widths", "index_dtype", "index_bytes_for",
           "rowell_padding_ratio", "choose_layout",
           "SELL_PADDING_THRESHOLD", "SELL_SLICE_ROWS"]


def bucket_up(x: int, *, minimum: int = 1) -> int:
    """Round ``x`` up to the next bucket edge (powers of two).

    Bucket edges bound the number of distinct compiled shapes by
    ``O(log max_size)`` per dimension — the compile-cache policy of the
    batched solver.
    """
    x = max(int(x), minimum)
    return 1 << (x - 1).bit_length()


def lane_bucket_up(x: int, *, parts: int = 1, minimum: int = 1) -> int:
    """Round a *lane* count up to a bucket edge that ``parts`` shards
    divide evenly: the power-of-two edge of :func:`bucket_up`, rounded up
    to a multiple of ``parts``.  The lane-sharded serving pool
    (:mod:`repro_torch.core.shard`) gives each of its D shards the same
    number of lanes; ``parts=1`` is :func:`bucket_up` exactly."""
    t = bucket_up(x, minimum=minimum)
    parts = max(int(parts), 1)
    return -(-t // parts) * parts


def _pad_axis(a: np.ndarray, axis: int, size: int) -> np.ndarray:
    if a.shape[axis] == size:
        return a
    if a.shape[axis] > size:
        raise ValueError(f"cannot shrink axis {axis}: {a.shape[axis]} > {size}")
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, size - a.shape[axis])
    return np.pad(a, widths)


def pad_bell(m: BellMatrix, *, n_row_blocks: int, n_slabs: int,
             slab_len: int) -> BellMatrix:
    """Zero-pad a flat-slab banked-ELL matrix to the given structural dims."""
    def pad3(a):
        a = _pad_axis(a, 0, n_row_blocks)
        a = _pad_axis(a, 1, n_slabs)
        return _pad_axis(a, 2, slab_len)

    return dataclasses.replace(
        m,
        tile_cols=_pad_axis(_pad_axis(m.tile_cols, 0, n_row_blocks), 1, n_slabs),
        vals=pad3(m.vals),
        local_rows=pad3(m.local_rows),
        local_cols=pad3(m.local_cols))


def pad_ellpack(m: EllpackMatrix, *, n_row_blocks: int, n_slabs: int,
                ell: int) -> EllpackMatrix:
    """Zero-pad a slot-major ELLPACK matrix to the given structural dims."""
    def pad4(a):
        a = _pad_axis(a, 0, n_row_blocks)
        a = _pad_axis(a, 1, n_slabs)
        return _pad_axis(a, 2, ell)

    return dataclasses.replace(
        m,
        tile_cols=_pad_axis(_pad_axis(m.tile_cols, 0, n_row_blocks), 1, n_slabs),
        vals=pad4(m.vals),
        local_cols=pad4(m.local_cols))


@dataclasses.dataclass(frozen=True)
class StackedBell:
    """B flat-slab banked-ELL matrices padded to one shape, stacked on axis 0."""

    tile_cols: np.ndarray   # int32[G, B, T]
    vals: np.ndarray        # v[G, B, T, L]
    local_rows: np.ndarray  # int32[G, B, T, L]
    local_cols: np.ndarray  # int32[G, B, T, L]
    shapes: Tuple[Tuple[int, int], ...]   # logical per-lane shapes
    nnzs: Tuple[int, ...]
    block_rows: int
    col_tile: int
    n_col_tiles: int        # shared padded x-tile count

    @property
    def batch(self) -> int:
        return int(self.vals.shape[0])

    @property
    def padded_rows(self) -> int:
        return int(self.vals.shape[1]) * self.block_rows

    @property
    def padded_cols(self) -> int:
        return self.n_col_tiles * self.col_tile


@dataclasses.dataclass(frozen=True)
class StackedEllpack:
    """B slot-major ELLPACK matrices padded to one shape, stacked on axis 0."""

    tile_cols: np.ndarray   # int32[G, B, T]
    vals: np.ndarray        # v[G, B, T, E, R]
    local_cols: np.ndarray  # int32[G, B, T, E, R]
    shapes: Tuple[Tuple[int, int], ...]
    nnzs: Tuple[int, ...]
    block_rows: int
    col_tile: int
    n_col_tiles: int

    @property
    def batch(self) -> int:
        return int(self.vals.shape[0])

    @property
    def padded_rows(self) -> int:
        return int(self.vals.shape[1]) * self.block_rows

    @property
    def padded_cols(self) -> int:
        return self.n_col_tiles * self.col_tile


def stack_bell(mats: Sequence[BellMatrix], *, bucket: bool = True) -> StackedBell:
    """Pad a heterogeneous list of BellMatrix to one (bucketed) shape and stack.

    All inputs must share ``block_rows``/``col_tile`` (they parameterize
    the kernel, not the problem).  With ``bucket=True`` every structural
    dim is rounded up to a power-of-two edge so different batches of
    similar problems reuse the same compiled solver.
    """
    if not mats:
        raise ValueError("stack_bell needs at least one matrix")
    r, c = mats[0].block_rows, mats[0].col_tile
    for m in mats:
        if (m.block_rows, m.col_tile) != (r, c):
            raise ValueError("all matrices must share block_rows/col_tile")
    rnd = bucket_up if bucket else (lambda x, minimum=1: max(int(x), minimum))
    B = rnd(max(m.n_row_blocks for m in mats))
    T = rnd(max(m.n_slabs for m in mats))
    L = rnd(max(m.slab_len for m in mats))
    n_tiles = rnd(max(m.n_col_tiles for m in mats))
    padded = [pad_bell(m, n_row_blocks=B, n_slabs=T, slab_len=L) for m in mats]
    return StackedBell(
        tile_cols=np.stack([m.tile_cols for m in padded]),
        vals=np.stack([m.vals for m in padded]),
        local_rows=np.stack([m.local_rows for m in padded]),
        local_cols=np.stack([m.local_cols for m in padded]),
        shapes=tuple(m.shape for m in mats),
        nnzs=tuple(m.nnz for m in mats),
        block_rows=r, col_tile=c, n_col_tiles=n_tiles)


def stack_ellpack(mats: Sequence[EllpackMatrix], *,
                  bucket: bool = True) -> StackedEllpack:
    """Pad a heterogeneous list of EllpackMatrix to one shape and stack.

    Feeds the batched ELLPACK SpMV
    (:func:`repro_torch.kernels.spmv.spmv_ellpack`).
    """
    if not mats:
        raise ValueError("stack_ellpack needs at least one matrix")
    r, c = mats[0].block_rows, mats[0].col_tile
    for m in mats:
        if (m.block_rows, m.col_tile) != (r, c):
            raise ValueError("all matrices must share block_rows/col_tile")
    rnd = bucket_up if bucket else (lambda x, minimum=1: max(int(x), minimum))
    B = rnd(max(m.n_row_blocks for m in mats))
    T = rnd(max(m.n_slabs for m in mats))
    E = rnd(max(m.ell for m in mats))
    n_tiles = rnd(max(m.n_col_tiles for m in mats))
    padded = [pad_ellpack(m, n_row_blocks=B, n_slabs=T, ell=E) for m in mats]
    return StackedEllpack(
        tile_cols=np.stack([m.tile_cols for m in padded]),
        vals=np.stack([m.vals for m in padded]),
        local_cols=np.stack([m.local_cols for m in padded]),
        shapes=tuple(m.shape for m in mats),
        nnzs=tuple(m.nnz for m in mats),
        block_rows=r, col_tile=c, n_col_tiles=n_tiles)


def flatten_bell(m: BellMatrix):
    """Flatten a banked-ELL matrix to its packed nonzero stream.

    Returns ``(global_cols, vals, rows)`` int32/value/int32 1-D arrays —
    the closest host-side analogue of the Serpens/Callipepla per-channel
    packed (col, row, val) stream.  Padding entries carry
    ``(0, 0.0, 0)``: they add ``0 · x[0]`` to row 0, so a flat stream
    can be zero-extended to ANY length without changing the product, so
    a stack of streams buckets only this one dimension.
    """
    C, R = m.col_tile, m.block_rows
    gcols = (m.tile_cols[:, :, None] * C + m.local_cols).reshape(-1)
    blk = np.arange(m.n_row_blocks, dtype=np.int64)[:, None, None]
    rows = (blk * R + m.local_rows).reshape(-1)
    return (gcols.astype(np.int32), m.vals.reshape(-1).copy(),
            rows.astype(np.int32))


@dataclasses.dataclass(frozen=True)
class StackedFlat:
    """B packed nonzero streams padded to one length, stacked on axis 0.

    The operand of :func:`repro_torch.core.batch.batched_matvec_flat`
    (no solver path uses it): bucketing the *stream length* (one
    dimension) instead of (row blocks × slabs × slab len) independently
    keeps padding waste ≤ 2× per lane where the 3-D bucket compounds to
    ~8×.
    """

    gcols: np.ndarray       # int32[G, N] global column per nonzero
    vals: np.ndarray        # v[G, N]
    rows: np.ndarray        # int32[G, N] global (padded) row per nonzero
    shapes: Tuple[Tuple[int, int], ...]
    nnzs: Tuple[int, ...]
    block_rows: int
    col_tile: int
    n_row_blocks: int       # shared (bucketed) row-block count
    n_col_tiles: int

    @property
    def batch(self) -> int:
        return int(self.vals.shape[0])

    @property
    def padded_rows(self) -> int:
        return self.n_row_blocks * self.block_rows

    @property
    def padded_cols(self) -> int:
        return self.n_col_tiles * self.col_tile


def stack_flat(mats: Sequence[BellMatrix], *, bucket: bool = True) -> StackedFlat:
    """Flatten + pad + stack banked-ELL matrices as packed nonzero streams."""
    if not mats:
        raise ValueError("stack_flat needs at least one matrix")
    r, c = mats[0].block_rows, mats[0].col_tile
    for m in mats:
        if (m.block_rows, m.col_tile) != (r, c):
            raise ValueError("all matrices must share block_rows/col_tile")
    rnd = bucket_up if bucket else (lambda x, minimum=1: max(int(x), minimum))
    flats = [flatten_bell(m) for m in mats]
    N = rnd(max(f[0].shape[0] for f in flats))
    B = rnd(max(m.n_row_blocks for m in mats))
    n_tiles = rnd(max(m.n_col_tiles for m in mats))
    G = len(mats)
    gcols = np.zeros((G, N), np.int32)
    vals = np.zeros((G, N), mats[0].vals.dtype)
    rows = np.zeros((G, N), np.int32)
    for g, (gc, v, rw) in enumerate(flats):
        gcols[g, : gc.shape[0]] = gc
        vals[g, : v.shape[0]] = v
        rows[g, : rw.shape[0]] = rw
    return StackedFlat(gcols, vals, rows,
                       shapes=tuple(m.shape for m in mats),
                       nnzs=tuple(m.nnz for m in mats),
                       block_rows=r, col_tile=c, n_row_blocks=B,
                       n_col_tiles=n_tiles)


# ---------------------------------------------------------- row-major ELL

#: Above this row-ELL padding ratio (Σ n·W / Σ nnz over the bag, with W
#: the *unbucketed* per-matrix max row width) the automatic layout
#: heuristic (``layout="auto"``) switches from row-ELL to sliced-ELL:
#: below it the global-W padding is cheap enough that the simpler
#: single-rectangle layout wins on dispatch overhead.
SELL_PADDING_THRESHOLD = 2.0

#: SELL-C-σ slice height C (rows per slice) — each C-row slice of the
#: length-sorted rows is padded only to its own max width.
SELL_SLICE_ROWS = 64


def index_dtype(n_pad: int) -> np.dtype:
    """Column-index dtype for a padded row count: ``int16`` when every
    index fits in a signed 16-bit lane (``n_pad < 2^15``), else
    ``int32`` — the narrow-index half of the nonzero stream budget."""
    return np.dtype(np.int16 if int(n_pad) < (1 << 15) else np.int32)


def index_bytes_for(n: int) -> int:
    """Stream bytes per stored column index for an ``n``-row problem
    once bucketed — what the roofline/byte accounting should charge."""
    return int(index_dtype(bucket_up(n)).itemsize)


def rowell_padding_ratio(csrs: Sequence) -> float:
    """Row-ELL padded-slot overhead ``Σ n·W / Σ nnz`` of a bag (W =
    unbucketed max row width per matrix).  1.0 = no padding; feeds the
    automatic row-ELL vs sliced-ELL choice (:func:`choose_layout`)."""
    tot_nnz = sum(max(int(a.nnz), 1) for a in csrs)
    tot_slots = 0
    for a in csrs:
        rn = np.asarray(a.row_nnz(), np.int64)
        w = max(int(rn.max()) if rn.size else 0, 1)
        tot_slots += a.shape[0] * w
    return tot_slots / max(tot_nnz, 1)


def choose_layout(csrs: Sequence, *, default: str = "rowell",
                  threshold: float = SELL_PADDING_THRESHOLD) -> str:
    """Pick the batched matrix layout for a bag: ``"sell"`` when the
    row-ELL padding ratio exceeds ``threshold`` (skewed row-length
    distributions), else ``default``."""
    return "sell" if rowell_padding_ratio(csrs) > threshold else default


def csr_rowell(a) -> Tuple[np.ndarray, np.ndarray]:
    """Row-major ELL arrays ``(cols int32[n, W], vals[n, W])`` from CSR.

    ``W`` = max nonzeros per row (≥ 1); short rows are padded with
    ``(col i, val 0)`` entries for row ``i`` — the padding *self-gathers*
    the row's own x entry and multiplies it by zero, so a non-finite
    value anywhere else in ``x`` (e.g. a diverging lane elsewhere in the
    batch bucket) can never poison row ``i`` through its padding.
    Entries keep their CSR (sorted-column) order within a row, so the
    SpMV accumulation order is deterministic per row.

    This is the *scatter-free* batched layout: ``y[i] = Σ_w vals[i, w] ·
    x[cols[i, w]]`` is a gather + a reduction over the width axis.
    """
    n = a.shape[0]
    rn = np.asarray(a.row_nnz(), np.int64)
    W = max(int(rn.max()) if n else 0, 1)
    own = np.arange(n, dtype=np.int64)[:, None]
    cols = np.broadcast_to(own, (n, W)).astype(np.int32)
    vals = np.zeros((n, W), a.data.dtype)
    if a.nnz:
        idx = a.indptr[:-1, None] + np.arange(W, dtype=np.int64)[None, :]
        mask = np.arange(W)[None, :] < rn[:, None]
        safe = np.clip(idx, 0, a.nnz - 1)
        cols = np.where(mask, a.indices[safe], own).astype(np.int32)
        vals = np.where(mask, a.data[safe], 0)
    return cols, vals


@dataclasses.dataclass(frozen=True)
class StackedRowEll:
    """B row-major ELL matrices padded to one ``(n_pad, W)`` shape and
    stacked on axis 0 — the ``backend="xla"`` default matrix operand.

    Storage is **slot-major** ``[G, W, n_pad]`` (slot index before row
    index): the SpMV's width reduction is a halving tree over axis 1,
    and slot-major keeps each tree add contiguous over the row lanes.
    Values are packed **at rest** at ``scheme.host_matrix_dtype`` and column
    indices at :func:`index_dtype` of ``n_pad``, so the stored bytes are
    exactly what the scheme's stream budget charges.  Padded rows
    (beyond a lane's logical ``n``) self-gather their own (zero) x entry
    with val 0; the caller gives them unit diagonal / zero rhs so they
    never influence termination.  Both dims are bucketed (power-of-two
    edges).
    """

    cols: np.ndarray        # int16/int32[G, W, n_pad] column index per slot
    vals: np.ndarray        # matrix_dtype[G, W, n_pad]
    shapes: Tuple[Tuple[int, int], ...]
    nnzs: Tuple[int, ...]

    @property
    def batch(self) -> int:
        return int(self.vals.shape[0])

    @property
    def padded_rows(self) -> int:
        return int(self.vals.shape[2])

    @property
    def width(self) -> int:
        return int(self.vals.shape[1])

    @property
    def padding_ratio(self) -> float:
        """Stored slots per logical nonzero (1.0 = no padding)."""
        return self.vals.size / max(sum(self.nnzs), 1)

    @property
    def index_bytes(self) -> int:
        return int(self.cols.dtype.itemsize)

    def stream_bytes_per_nnz(self) -> float:
        """Measured at-rest matrix-stream bytes (values + indices, all
        padding included) per logical nonzero."""
        return (self.vals.nbytes + self.cols.nbytes) / max(sum(self.nnzs), 1)


def stack_rowell(csrs: Sequence, *, bucket: bool = True,
                 scheme=None) -> StackedRowEll:
    """Pad a heterogeneous list of CSR matrices to one row-ELL shape and
    stack along a new leading batch axis (see :func:`csr_rowell`).

    With ``scheme=`` (a :class:`~repro_torch.core.precision
    .PrecisionScheme`) values are cast to ``scheme.host_matrix_dtype``
    here, at stacking time — the at-rest packing the paper budgets —
    instead of per matvec.
    """
    if not csrs:
        raise ValueError("stack_rowell needs at least one matrix")
    rnd = bucket_up if bucket else (lambda x, minimum=1: max(int(x), minimum))
    lanes = [csr_rowell(a) for a in csrs]
    n_pad = rnd(max(a.shape[0] for a in csrs))
    W = rnd(max(c.shape[1] for c, _ in lanes))
    G = len(csrs)
    vdt = (scheme.host_matrix_dtype if scheme is not None
           else lanes[0][1].dtype)
    idt = index_dtype(n_pad)
    # Every slot self-gathers by default so padded rows/slots read the
    # row's own x entry (see csr_rowell: no cross-row poisoning).
    cols = np.broadcast_to(np.arange(n_pad, dtype=idt),
                           (G, W, n_pad)).copy()
    vals = np.zeros((G, W, n_pad), vdt)
    for g, (c, v) in enumerate(lanes):
        cols[g, : c.shape[1], : c.shape[0]] = c.T
        vals[g, : v.shape[1], : v.shape[0]] = host_values(v.T, vdt)
    return StackedRowEll(cols, vals,
                         shapes=tuple(a.shape for a in csrs),
                         nnzs=tuple(a.nnz for a in csrs))


# ------------------------------------------------------- sliced ELL (SELL)
@dataclasses.dataclass(frozen=True)
class StackedSell:
    """B matrices in a stacked **SELL-C-σ** (sliced-ELL) layout.

    Rows are sorted by descending nonzero count within σ-row windows
    (stable, so equal-length rows keep their order), sliced into C-row
    chunks, and each slice is padded only to its own (cross-lane,
    bucketed) max width — skewed matrices store ~nnz slots instead of
    row-ELL's ``n·W``.  Contiguous equal-width slices are merged into
    static ``(rows, width)`` *groups*; group data is stored slot-major
    (``[width, rows]`` flattened) back to back in flat ``[G, L]``
    arrays, values at ``scheme.host_matrix_dtype`` and indices at
    :func:`index_dtype` — the at-rest packing the stream budget charges.

    ``iperm[g, i]`` is the sorted position of original row ``i``:
    ``y = take_along_axis(y_sorted, iperm, axis=1)`` undoes the sort.
    ``lane_widths[g, s]`` is lane g's own need in slice s (its widest
    sorted row there, unbucketed): the slots a kernel has to read,
    where the stored width is the cross-lane bucket.
    Within-row slot order is untouched by the permutation and the
    per-row reduction uses the same halving tree as row-ELL, so SpMV
    results are **bit-identical** to row-ELL for every scheme.  Padded
    slots self-gather (col = own row id, val 0) like row-ELL.
    """

    cols: np.ndarray    # int16/int32[G, L] flat slot-major column ids
    vals: np.ndarray    # matrix_dtype[G, L]
    iperm: np.ndarray   # int32[G, n_pad] original row -> sorted position
    groups: Tuple[Tuple[int, int], ...]  # static (rows, width) runs
    slice_rows: int     # C
    sort_window: int    # σ
    shapes: Tuple[Tuple[int, int], ...]
    nnzs: Tuple[int, ...]
    lane_widths: np.ndarray  # int32[G, n_slices] per-lane exact widths

    @property
    def batch(self) -> int:
        return int(self.vals.shape[0])

    @property
    def padded_rows(self) -> int:
        return int(self.iperm.shape[1])

    @property
    def total_slots(self) -> int:
        return int(self.vals.shape[1])

    @property
    def padding_ratio(self) -> float:
        """Stored slots per logical nonzero (1.0 = no padding)."""
        return self.vals.size / max(sum(self.nnzs), 1)

    @property
    def index_bytes(self) -> int:
        return int(self.cols.dtype.itemsize)

    def stream_bytes_per_nnz(self) -> float:
        """Measured at-rest matrix-stream bytes (values + indices, all
        padding included) per logical nonzero."""
        return (self.vals.nbytes + self.cols.nbytes) / max(sum(self.nnzs), 1)


def sell_slice_widths(csrs: Sequence, *, n_pad: int,
                      slice_rows: int = SELL_SLICE_ROWS,
                      sort_window: int | None = None,
                      bucket: bool = True) -> Tuple[int, ...]:
    """Per-slice padded widths a :func:`stack_sell` of this bag would
    use at the given ``n_pad`` — the growable half of a serving pool's
    sell bucket signature (widths only ever grow as lanes are merged)."""
    rnd = bucket_up if bucket else (lambda x, minimum=1: max(int(x), minimum))
    C = max(1, min(int(slice_rows), n_pad))
    sigma = n_pad if sort_window is None else max(C, min(int(sort_window),
                                                         n_pad))
    widths = None
    for a in csrs:
        rn = np.zeros(n_pad, np.int64)
        rn[: a.shape[0]] = a.row_nnz()
        srt = np.concatenate([np.sort(rn[w0:min(w0 + sigma, n_pad)])[::-1]
                              for w0 in range(0, n_pad, sigma)])
        lane = [int(srt[r0:min(r0 + C, n_pad)].max())
                for r0 in range(0, n_pad, C)]
        widths = lane if widths is None else [max(x, y) for x, y
                                              in zip(widths, lane)]
    return tuple(int(rnd(w)) if w > 0 else 0 for w in widths)


def _sell_groups(widths: Sequence[int], *, n_pad: int,
                 slice_rows: int) -> Tuple[Tuple[int, int], ...]:
    """Merge contiguous equal-width slices into static (rows, width)
    groups; Σ rows = n_pad."""
    groups: list = []
    for s, w in enumerate(widths):
        rows = min(slice_rows, n_pad - s * slice_rows)
        if groups and groups[-1][1] == w:
            groups[-1] = (groups[-1][0] + rows, w)
        else:
            groups.append((rows, w))
    return tuple((int(r), int(w)) for r, w in groups)


def stack_sell(csrs: Sequence, *, bucket: bool = True, scheme=None,
               slice_rows: int = SELL_SLICE_ROWS,
               sort_window: int | None = None,
               n_pad: int | None = None,
               widths: Sequence[int] | None = None) -> StackedSell:
    """Stack a heterogeneous list of CSR matrices in SELL-C-σ layout
    (see :class:`StackedSell`).  ``sort_window=None`` sorts globally
    (σ = n_pad, maximum padding compression); widths are shared across
    lanes and bucketed to power-of-two edges when ``bucket=True``.

    ``n_pad``/``widths`` override the derived geometry — the serving
    pool uses them to pack a single admitted lane into an existing
    pool bucket without re-deriving (and possibly shrinking) the
    shared slice widths.  Given widths must cover the data
    (``ValueError`` otherwise: a too-narrow slice would silently drop
    nonzeros)."""
    if not csrs:
        raise ValueError("stack_sell needs at least one matrix")
    rnd = bucket_up if bucket else (lambda x, minimum=1: max(int(x), minimum))
    G = len(csrs)
    n_auto = rnd(max(a.shape[0] for a in csrs))
    n_pad = n_auto if n_pad is None else int(n_pad)
    if n_pad < max(a.shape[0] for a in csrs):
        raise ValueError(f"n_pad={n_pad} smaller than the largest lane")
    C = max(1, min(int(slice_rows), n_pad))
    sigma = n_pad if sort_window is None else max(C, min(int(sort_window),
                                                         n_pad))
    vdt = scheme.host_matrix_dtype if scheme is not None \
        else np.asarray(csrs[0].data).dtype
    idt = index_dtype(n_pad)

    # Per-lane padded row-nnz + stable descending-length sort within
    # σ-row windows.
    rns, perms = [], []
    iperm = np.zeros((G, n_pad), np.int32)
    for g, a in enumerate(csrs):
        rn = np.zeros(n_pad, np.int64)
        rn[: a.shape[0]] = a.row_nnz()
        perm = np.empty(n_pad, np.int64)
        for w0 in range(0, n_pad, sigma):
            w1 = min(w0 + sigma, n_pad)
            perm[w0:w1] = w0 + np.argsort(-rn[w0:w1], kind="stable")
        inv = np.empty(n_pad, np.int64)
        inv[perm] = np.arange(n_pad)
        rns.append(rn)
        perms.append(perm)
        iperm[g] = inv.astype(np.int32)

    # Shared per-slice widths: cross-lane max, bucketed; 0 = all-empty.
    # Each lane's own per-slice need is kept beside them.
    n_slices = -(-n_pad // C)
    lane_widths = np.zeros((G, n_slices), np.int32)
    for g in range(G):
        srt = np.zeros(n_slices * C, np.int64)
        srt[:n_pad] = rns[g][perms[g]]
        lane_widths[g] = srt.reshape(n_slices, C).max(axis=1)
    need = [int(w) for w in lane_widths.max(axis=0)]
    if widths is None:
        widths = [int(rnd(w)) if w > 0 else 0 for w in need]
    else:
        widths = [int(w) for w in widths]
        if len(widths) != n_slices or any(w < d for w, d in
                                          zip(widths, need)):
            raise ValueError(
                f"given widths {widths} do not cover the data's "
                f"per-slice requirements {need} at n_pad={n_pad}")
    groups = _sell_groups(widths, n_pad=n_pad, slice_rows=C)
    L = sum(r * w for r, w in groups)

    cols = np.zeros((G, max(L, 1)), idt)[:, :L]
    vals = np.zeros((G, max(L, 1)), vdt)[:, :L]
    for g, a in enumerate(csrs):
        n = a.shape[0]
        rn, perm = rns[g], perms[g]
        ip = np.full(n_pad, a.nnz, np.int64)
        ip[:n] = a.indptr[:-1]
        off = r0 = 0
        for rows, w in groups:
            rws = perm[r0:r0 + rows]
            r0 += rows
            if w == 0:
                continue
            if a.nnz:
                idx = ip[rws][:, None] + np.arange(w, dtype=np.int64)[None, :]
                mask = np.arange(w)[None, :] < rn[rws][:, None]
                safe = np.clip(idx, 0, a.nnz - 1)
                c = np.where(mask, a.indices[safe], rws[:, None])
                v = np.where(mask, a.data[safe], 0)
            else:
                c = np.broadcast_to(rws[:, None], (rows, w))
                v = np.zeros((rows, w), a.data.dtype)
            cols[g, off:off + rows * w] = c.T.astype(idt).ravel()
            vals[g, off:off + rows * w] = host_values(v.T, vdt).ravel()
            off += rows * w
    return StackedSell(cols, vals, iperm, groups, slice_rows=C,
                       sort_window=sigma,
                       shapes=tuple(a.shape for a in csrs),
                       nnzs=tuple(a.nnz for a in csrs),
                       lane_widths=lane_widths)
