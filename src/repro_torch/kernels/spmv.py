"""SpMV kernels for Hopper, each beside its plain PyTorch version.

Two hand-written CUDA C++ kernels (``csrc/``, built by
:mod:`repro_torch.kernels._build` with ``--fmad=false`` for ``sm_90a``)
replace the three Pallas SpMV kernels of the JAX package:

* :func:`spmv_sell` replaces ``repro/kernels/spmv.py::spmv_pallas_sell``
  (batched SELL-C-σ; row-ELL is its one-group case).  The stored layout
  pads slice k of every lane to the widest lane's width; a
  :class:`SellTable` built once per pack gives the kernel each lane's own
  width per slice, so it reads only those slots, and interleaves the
  lanes' blocks.  A row of lane width w gets clamp(next_pow2(w) / 32, 1,
  32) threads, each folding its leaves in registers, the threads'
  partials by warp shuffles and one shared-memory exchange, so hub rows of
  skewed matrices are not one serial chain and stencil rows take one
  thread each; x is gathered through the read-only cache because an fp64
  lane of the main path's 2^18 rows (2 MB) cannot sit in a block's shared
  memory, while a bag of lanes fits the 50 MB L2.
* :func:`spmv_ellpack` replaces ``repro/kernels/spmv.py::
  spmv_pallas_batched`` (batched banked ELLPACK).  One block per (lane,
  row block), one thread per row; the slab walk that the TPU ran as a
  sequential grid axis is a loop inside the block, with no shared memory
  and no barrier: x is gathered from its tile through the read-only
  cache (an fp64 x of 10^6 rows fits the 50 MB L2), the next slab's
  values and indices load before this slab's tree, and the tree over E
  is unrolled at compile time for ``next_pow2(E) ≤ 32`` so its partials
  stay in registers (wider slabs take the generic ``tree_sum``).  At
  G = 1 the same kernel is :func:`spmv_ell`, the port of ``spmv_pallas``
  (the single-system solver's M1), with a launch count of its own.

Both are bound by bytes on the H100: each stored slot (value + index) is
read once, x gathered, y written once, at 2 flops per slot — the least
time is those bytes over 3.35 TB/s.  Their designs keep the stream at
the scheme's at-rest width (fp32 values under the mixed schemes, bf16
under the TPU tier's ``tpu_v*``, int16 indices below 2^15 rows in SELL)
and keep x reads on chip (L2).

Each kernel is instantiated per (value, x, accumulator) dtype triple
(:data:`_INSTANTIATION`): the faithful schemes', mixed_v1's (f32, f32,
f32) for ``tpu_fp32`` too, and the tier's bf16 triples.  At a bf16
accumulator (``tpu_v1``) every product and sum rounds to bf16, as eager
PyTorch rounds its bf16 ops (``csrc/tree_sum.cuh``).

Bracketing is part of the contract: the SELL kernel computes
``rounded_products`` (``v·x + x·0``) and the fixed halving ``tree_sum``
over the next power of two of the lane's width (slots past that width
are +0 leaves), so it is bitwise equal to its plain version given the
same table, and equal to the JAX reference up to the sign of an all-zero
sum (the reference's wider tree adds +0 at its top levels); the ELLPACK
kernel fixes the order the reference leaves to ``jnp.sum`` (tree over E,
slabs added in order), equal bitwise to its plain version and within
``_MV_RTOL`` of JAX.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  :data:`LAUNCHES` counts the
launches of each kernel (one per launch, nowhere else).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.precision import PrecisionScheme, get_scheme
from repro_torch.kernels._launch import (I, LL, P, check_cuda, function,
                                         on_cpu, raise_on_error)

__all__ = ["spmv_sell", "spmv_sell_plain", "SellTable", "sell_table",
           "spmv_ellpack", "spmv_ellpack_plain", "spmv_ell",
           "spmv_ell_plain", "LAUNCHES", "reset_launches"]

_KERNELS = ("spmv_sell", "spmv_ellpack", "spmv_ell")
#: The TPU tier's schemes: their launches are also counted apart, under
#: ``"<kernel>[<scheme>]"``.
TIER_SCHEMES = ("tpu_fp32", "tpu_v1", "tpu_v2", "tpu_v3")

#: Kernel launches per wrapper since the last :func:`reset_launches`: every
#: launch under the kernel's name, a TPU-tier one also under
#: ``"<kernel>[<scheme>]"``.
LAUNCHES: Dict[str, int] = dict.fromkeys(
    _KERNELS + tuple(f"{k}[{s}]" for k in _KERNELS for s in TIER_SCHEMES), 0)

_f64, _f32, _bf16 = torch.float64, torch.float32, torch.bfloat16
#: (matrix, x, accumulator) dtypes -> the kernels' template instantiation
#: code (``scheme`` in ``csrc/spmv_{sell,ellpack}.cu``).  ``tpu_fp32`` is
#: mixed_v1's (f32, f32, f32); the caller casts y to ``vector_dtype``.
_INSTANTIATION = {(_f64, _f64, _f64): 0, (_f32, _f32, _f32): 1,
                  (_f32, _f32, _f64): 2, (_f32, _f64, _f64): 3,
                  (_bf16, _bf16, _bf16): 4, (_bf16, _bf16, _f32): 5,
                  (_bf16, _f32, _f32): 6}
_INDEX_BYTES = {torch.int16: 2, torch.int32: 4}
#: Threads of one SELL block (``kThreads`` in ``csrc/spmv_sell.cu``), the
#: most threads a row gets, and the fewest leaves a thread takes while a
#: row has them: a row of padded width wp gets
#: S = clamp(wp / SELL_MIN_LEAVES, 1, SELL_MAX_SUBSETS) threads.
SELL_THREADS = 256
SELL_MAX_SUBSETS = 32
SELL_MIN_LEAVES = 32
#: Leaves per thread the SELL kernel folds in registers (``kRegLeaves``);
#: a table with more takes the kernel's generic-tree instantiation.
SELL_REG_LEAVES = 64


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _scheme_code(scheme: PrecisionScheme) -> int:
    key = (scheme.matrix_dtype, scheme.spmv_in_dtype, scheme.spmv_acc_dtype)
    try:
        return _INSTANTIATION[key]
    except KeyError:
        raise NotImplementedError(
            f"no CUDA SpMV instantiation for scheme {scheme.name!r} "
            f"{key}") from None


def _count(name: str, scheme: PrecisionScheme) -> None:
    LAUNCHES[name] += 1
    if scheme.name in TIER_SCHEMES:
        LAUNCHES[f"{name}[{scheme.name}]"] += 1


# ------------------------------------------------------------------- SELL
def _pow2(w: np.ndarray) -> np.ndarray:
    """next_pow2(w) elementwise, 1 for w <= 1."""
    w = np.maximum(np.asarray(w, np.int64), 1)
    return np.left_shift(1, np.ceil(np.log2(w)).astype(np.int64))


@dataclasses.dataclass(frozen=True)
class SellTable:
    """The SELL kernel's launch table: which slots of which rows each block
    reads, built on the host once per pack and kept on the device.

    ``entries`` int64[E, 8] holds per entry ``(row0, rows, width, S,
    block0, base, stride, leaves)``: sorted rows ``row0 .. row0 + rows``
    of one lane read ``width`` slots each (their lane's own width, ≤ the
    stored width), with S threads a row (:func:`_subsets`) and
    ``leaves`` = next_pow2(width) / S per thread; slot j of the entry's row
    lr sits at flat ``base + j·stride + lr``.  An entry is one shared
    width group intersected with one run of slices of equal lane width.
    ``block_map`` int32[map_rows, grid_x] gives each block's entry (-1
    past the lane's own blocks); ``map_rows`` is G for a per-lane table
    and 1 for a shared one (every lane at the stored widths: row-ELL, or
    an operand packed without lane widths).  ``grid_x`` (the most blocks
    a lane needs), ``wide``, ``slots`` (slots read per launch: per lane
    for a shared table, over all lanes for a per-lane one) are host
    values, so a launch reads nothing back from the device.
    ``lane_widths`` int32[G, n_slices] (None when shared) is what the
    plain version needs; ``groups`` the stored geometry the entries
    address, checked against the operand at every launch.
    """

    groups: Tuple[Tuple[int, int], ...]
    entries: torch.Tensor
    block_map: torch.Tensor
    grid_x: int
    wide: bool
    slots: int
    lane_widths: Optional[torch.Tensor] = None
    slice_rows: int = 0

    @property
    def shared(self) -> bool:
        return self.lane_widths is None

    def streamed_slots(self, lanes: int) -> int:
        """Slots one launch over ``lanes`` lanes reads."""
        return self.slots * lanes if self.shared else self.slots

    def lanes(self, start: int, stop: int, device) -> "SellTable":
        """The table of lanes ``start:stop`` alone, on ``device``: a lane
        shard's (:mod:`repro_torch.core.shard`), built from those lanes'
        own widths, so each lane reads the slots it read in the whole
        bag's table."""
        device = torch.device(device)
        if self.shared:
            return _shared_table(self.groups, device)
        return sell_table(self.groups, device=device,
                          lane_widths=self.lane_widths[start:stop].cpu()
                          .numpy(), slice_rows=self.slice_rows)


def _subsets(width: np.ndarray) -> np.ndarray:
    """Threads per row: clamp(next_pow2(w) / SELL_MIN_LEAVES, 1,
    SELL_MAX_SUBSETS); 1 for an empty row.  One leaf a thread (S =
    next_pow2(w)) would give a stencil row 8 threads for its 5 slots and
    a barrier to fold them; with up to 32 leaves a thread the row's
    threads stay few and their loads many."""
    return np.clip(_pow2(width) // SELL_MIN_LEAVES, 1, SELL_MAX_SUBSETS)


def _group_geometry(groups):
    """Per group: first sorted row, flat offset, rows and stored width."""
    rows = np.array([r for r, _ in groups], np.int64)
    widths = np.array([w for _, w in groups], np.int64)
    row0 = np.concatenate([[0], np.cumsum(rows)[:-1]])
    off = np.concatenate([[0], np.cumsum(rows * widths)[:-1]])
    return row0, off, rows, widths


def sell_table(groups: Sequence[Tuple[int, int]], *, device,
               lane_widths: Optional[np.ndarray] = None,
               slice_rows: int = 0) -> SellTable:
    """The :class:`SellTable` of a stacked SELL operand.

    ``lane_widths`` int[G, n_slices] (``StackedSell.lane_widths``, slices
    of ``slice_rows`` sorted rows) gives each lane its own width per slice;
    None gives the shared table, every lane at the stored group widths."""
    groups = tuple((int(r), int(w)) for r, w in groups)
    n_pad = sum(r for r, _ in groups)
    g_row0, g_off, g_rows, g_w = _group_geometry(groups)
    if lane_widths is None:
        lane = np.zeros(len(groups), np.int64)
        row0, rows, width = g_row0, g_rows, g_w
        base, stride = g_off, g_rows
    else:
        lw = np.asarray(lane_widths, np.int64)
        C = int(slice_rows)
        G, n_slices = lw.shape
        if C < 1 or n_slices != -(-n_pad // C):
            raise ValueError(f"lane_widths {lw.shape} do not match n_pad="
                             f"{n_pad} at slice_rows={slice_rows}")
        # the group of each slice (groups hold whole slices)
        s_group = np.searchsorted(np.cumsum(g_rows), np.arange(n_slices) * C,
                                  side="right")
        if (lw > g_w[s_group][None]).any():
            raise ValueError("a lane width exceeds its stored group width")
        new = np.ones((G, n_slices), bool)
        new[:, 1:] = ((s_group[1:] != s_group[:-1])[None]
                      | (lw[:, 1:] != lw[:, :-1]))
        lane, s0 = np.nonzero(new)                     # run starts, lane-major
        flat = lane * n_slices + s0
        s1 = np.append(flat[1:], G * n_slices) - lane * n_slices
        row0 = s0 * C
        rows = np.minimum(s1 * C, n_pad) - row0
        width = lw[lane, s0]
        k = s_group[s0]
        base = g_off[k] + row0 - g_row0[k]
        stride = g_rows[k]
    S = _subsets(width)
    leaves = np.where(width > 0, _pow2(width) // S, 0)
    nb = -(-rows // (SELL_THREADS // S))
    ends = np.cumsum(nb)
    n_lanes = int(lane.max()) + 1
    lane_start = np.zeros(n_lanes + 1, np.int64)      # blocks before each lane
    np.maximum.at(lane_start, lane + 1, ends)
    lane_start = np.maximum.accumulate(lane_start)
    block0 = ends - nb - lane_start[lane]
    lane_blocks = np.diff(lane_start)
    grid_x = int(lane_blocks.max())
    bmap = np.full((n_lanes, grid_x), -1, np.int32)
    e = np.repeat(np.arange(len(nb)), nb)
    bmap[lane[e], block0[e] + np.arange(len(e)) - (ends - nb)[e]] = e
    entries = np.stack([row0, rows, width, S, block0, base, stride, leaves],
                       axis=1).astype(np.int64)
    dev = torch.device(device)
    return SellTable(
        groups=groups, entries=torch.from_numpy(entries).to(dev),
        block_map=torch.from_numpy(bmap).to(dev),
        grid_x=grid_x, wide=bool((leaves > SELL_REG_LEAVES).any()),
        slots=int((rows * width).sum()),
        lane_widths=(None if lane_widths is None else
                     torch.from_numpy(np.ascontiguousarray(
                         lane_widths, np.int32)).to(dev)),
        slice_rows=int(slice_rows) if lane_widths is not None else 0)


#: (device, groups) -> the shared table of an operand packed without lane
#: widths (row-ELL), built once.
_SHARED_TABLES: Dict[tuple, SellTable] = {}


def _shared_table(groups, device: torch.device) -> SellTable:
    key = (device, tuple(groups))
    table = _SHARED_TABLES.get(key)
    if table is None:
        table = _SHARED_TABLES[key] = sell_table(groups, device=device)
    return table


def _lane_tree(prod: torch.Tensor, wl: torch.Tensor) -> torch.Tensor:
    """``tree_sum`` over dim 1 of ``prod`` [G, w, rows], row (g, r) over
    its own next_pow2(wl[g, r]) leaves, leaves j ≥ wl[g, r] read as +0:
    the levels of the wider tree above a row's own width are skipped."""
    G, w, rows = prod.shape
    zero = torch.zeros((), dtype=prod.dtype, device=prod.device)
    j = torch.arange(w, device=prod.device)[None, :, None]
    p = torch.where(j < wl[:, None, :], prod, zero)
    wp = 1 << max(w - 1, 0).bit_length()
    if wp != w:
        p = torch.cat([p, p.new_zeros((G, wp - w, rows))], dim=1)
    own = torch.ones_like(wl)                           # next_pow2(wl)
    for _ in range(wp.bit_length() - 1):
        own = torch.where(own < wl, own * 2, own)
    while wp > 1:
        h = wp // 2
        p = torch.where((own >= wp)[:, None, :], p[:, :h] + p[:, h:], p[:, :h])
        wp = h
    return p[:, 0]


def spmv_sell_plain(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                    *, groups: Sequence[Tuple[int, int]], scheme,
                    table: Optional[SellTable] = None) -> torch.Tensor:
    """Plain PyTorch SELL SpMV: per width group, gather ``x[g, cols]``,
    :func:`~repro_torch.core.batch.rounded_products`, and
    :func:`~repro_torch.core.batch.tree_sum` over the width — with a
    per-lane ``table``, over each row's lane width (slots past it are +0
    leaves), as the kernel reads them.  Returns ``acc_dtype[G, n_pad]`` in
    sorted row order."""
    from repro_torch.core.batch import rounded_products, tree_sum
    scheme = get_scheme(scheme)
    acc = scheme.spmv_acc_dtype
    x_in = x.to(scheme.spmv_in_dtype)
    G, n_pad = x.shape
    wl = None
    if table is not None and not table.shared:
        wl = table.lane_widths.to(x.device, torch.int64).repeat_interleave(
            table.slice_rows, dim=1)[:, :n_pad]
    parts, off, r0 = [], 0, 0
    for rows, w in groups:
        if w == 0:
            parts.append(torch.zeros((G, rows), dtype=acc, device=x.device))
            r0 += rows
            continue
        c = cols[:, off:off + rows * w].long()
        v = vals[:, off:off + rows * w].reshape(G, w, rows)
        xg = torch.gather(x_in, 1, c).reshape(G, w, rows)
        prod = rounded_products(v, xg, acc)
        parts.append(tree_sum(prod, dim=1) if wl is None
                     else _lane_tree(prod, wl[:, r0:r0 + rows]))
        off += rows * w
        r0 += rows
    return torch.cat(parts, dim=1)


def spmv_sell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *,
              groups: Sequence[Tuple[int, int]], scheme,
              table: Optional[SellTable] = None) -> torch.Tensor:
    """Batched SELL-C-σ SpMV (the port of ``spmv_pallas_sell``).

    ``cols``/``vals`` are the flat slot-major ``[G, L]`` arrays of
    :func:`repro_torch.sparse.stacking.stack_sell` (int16/int32 indices,
    values at ``scheme.matrix_dtype``), ``x`` is ``[G, n_pad]``, ``groups``
    the static ``(rows, width)`` runs (row-ELL: ``((n_pad, W),)`` over the
    flattened ``[G, W, n_pad]`` arrays), ``table`` the operand's
    :class:`SellTable` (None: the shared one, every lane at the stored
    widths).  One launch.  Returns ``acc_dtype[G, n_pad]`` in **sorted**
    row order; the caller applies ``iperm`` and the cast to
    ``vector_dtype``.
    """
    scheme = get_scheme(scheme)
    if on_cpu("spmv_sell", x):
        return spmv_sell_plain(cols, vals, x, groups=groups, scheme=scheme,
                               table=table)
    code = _scheme_code(scheme)
    G, n_pad = x.shape
    if cols.dim() != 2 or cols.shape != vals.shape or cols.shape[0] != G:
        raise ValueError(f"spmv_sell: cols {tuple(cols.shape)} / vals "
                         f"{tuple(vals.shape)} do not match x {(G, n_pad)}")
    if cols.dtype not in _INDEX_BYTES:
        raise ValueError(f"spmv_sell: cols dtype {cols.dtype} is not "
                         "int16/int32")
    if vals.dtype != scheme.matrix_dtype:
        raise ValueError(f"spmv_sell: vals dtype {vals.dtype} is not the "
                         f"scheme's {scheme.matrix_dtype}")
    L = int(cols.shape[1])
    if (sum(r for r, _ in groups) != n_pad
            or sum(r * w for r, w in groups) != L):
        raise ValueError(f"spmv_sell: groups {groups} do not cover "
                         f"n_pad={n_pad}, L={L}")
    if table is None:
        table = _shared_table(groups, x.device)
    map_rows = table.block_map.shape[0]
    if (map_rows not in (1, G) or table.groups != tuple(map(tuple, groups))
            or table.block_map.device != x.device):
        raise ValueError(f"spmv_sell: a table of {map_rows} lanes over "
                         f"groups {table.groups} on {table.block_map.device} "
                         f"for x {(G, n_pad)} over groups {groups} on "
                         f"{x.device}")
    x_in = x.to(scheme.spmv_in_dtype).contiguous()
    check_cuda("spmv_sell", x.device, cols=cols, vals=vals,
               entries=table.entries, block_map=table.block_map)
    y = torch.empty((G, n_pad), dtype=scheme.spmv_acc_dtype, device=x.device)
    fn = function("spmv_sell", "spmv_sell",
                  [I, I, P, P, P, P, I, LL, I, P, P, I, I, I, P])
    with torch.cuda.device(x.device):
        err = fn(code, _INDEX_BYTES[cols.dtype], cols.data_ptr(),
                 vals.data_ptr(), x_in.data_ptr(), y.data_ptr(), G, L, n_pad,
                 table.entries.data_ptr(), table.block_map.data_ptr(),
                 table.grid_x, map_rows, int(table.wide),
                 torch.cuda.current_stream().cuda_stream)
    raise_on_error("spmv_sell", "spmv_sell", err)
    _count("spmv_sell", scheme)
    return y


# ---------------------------------------------------------------- ELLPACK
def spmv_ellpack_plain(tile_cols: torch.Tensor, vals: torch.Tensor,
                       local_cols: torch.Tensor, x_tiles: torch.Tensor, *,
                       scheme) -> torch.Tensor:
    """Plain PyTorch banked-ELLPACK SpMV: per slab, gather the x tile
    ``tile_cols[g, i, t]`` and its ``local_cols`` entries, reduce the
    products with :func:`~repro_torch.core.batch.tree_sum` over E, and
    add the slabs in order.  Returns ``acc_dtype[G, B, R]``."""
    from repro_torch.core.batch import tree_sum
    scheme = get_scheme(scheme)
    acc = scheme.spmv_acc_dtype
    G, B, T, E, R = vals.shape
    C = x_tiles.shape[-1]
    x_in = x_tiles.to(scheme.spmv_in_dtype)
    tiles = tile_cols.long().reshape(G, B * T, 1).expand(G, B * T, C)
    xt = torch.gather(x_in, 1, tiles).reshape(G, B, T, C)
    xg = torch.gather(xt, 3, local_cols.long().reshape(G, B, T, E * R))
    prod = vals.to(acc) * xg.reshape(G, B, T, E, R).to(acc)
    s = tree_sum(prod, dim=3)                             # [G, B, T, R]
    y = torch.zeros((G, B, R), dtype=acc, device=x_tiles.device)
    for t in range(T):
        y = y + s[:, :, t]
    return y


def spmv_ellpack(tile_cols: torch.Tensor, vals: torch.Tensor,
                 local_cols: torch.Tensor, x_tiles: torch.Tensor, *,
                 scheme) -> torch.Tensor:
    """Batched banked-ELLPACK SpMV (the port of ``spmv_pallas_batched``).

    ``tile_cols`` int32[G, B, T], ``vals`` matrix_dtype[G, B, T, E, R],
    ``local_cols`` int32[G, B, T, E, R], ``x_tiles`` [G, n_col_tiles, C]
    (cast to ``spmv_in_dtype`` here).  Returns ``acc_dtype[G, B, R]``.
    """
    scheme = get_scheme(scheme)
    if on_cpu("spmv_ellpack", x_tiles):
        return spmv_ellpack_plain(tile_cols, vals, local_cols, x_tiles,
                                  scheme=scheme)
    y = _launch_ellpack("spmv_ellpack", tile_cols, vals, local_cols,
                        x_tiles, scheme)
    _count("spmv_ellpack", scheme)
    return y


def _launch_ellpack(name, tile_cols, vals, local_cols, x_tiles,
                    scheme: PrecisionScheme) -> torch.Tensor:
    """Check the batched shapes and launch ``csrc/spmv_ellpack.cu``."""
    code = _scheme_code(scheme)
    G, B, T, E, R = vals.shape
    _, n_ct, C = x_tiles.shape
    if (tuple(tile_cols.shape) != (G, B, T)
            or local_cols.shape != vals.shape or x_tiles.shape[0] != G):
        raise ValueError(
            f"{name}: shapes tile_cols {tuple(tile_cols.shape)}, vals "
            f"{tuple(vals.shape)}, local_cols {tuple(local_cols.shape)}, "
            f"x_tiles {tuple(x_tiles.shape)} do not match")
    if tile_cols.dtype != torch.int32 or local_cols.dtype != torch.int32:
        raise ValueError(f"{name}: tile_cols/local_cols must be int32")
    if vals.dtype != scheme.matrix_dtype:
        raise ValueError(f"{name}: vals dtype {vals.dtype} is not the "
                         f"scheme's {scheme.matrix_dtype}")
    if R > 1024:
        raise ValueError(f"{name}: block_rows {R} exceeds the 1024 "
                         "threads of a CUDA block")
    x_in = x_tiles.to(scheme.spmv_in_dtype).contiguous()
    check_cuda(name, x_tiles.device, tile_cols=tile_cols, vals=vals,
               local_cols=local_cols)
    y = torch.empty((G, B, R), dtype=scheme.spmv_acc_dtype,
                    device=x_tiles.device)
    fn = function("spmv_ellpack", "spmv_ellpack",
                  [I, P, P, P, P, P, I, I, I, I, I, I, I, P])
    with torch.cuda.device(x_tiles.device):
        err = fn(code, tile_cols.data_ptr(), vals.data_ptr(),
                 local_cols.data_ptr(), x_in.data_ptr(), y.data_ptr(), G, B,
                 T, E, R, n_ct, C, torch.cuda.current_stream().cuda_stream)
    raise_on_error("spmv_ellpack", name, err)
    return y


# ------------------------------------------------- single-system ELLPACK
def spmv_ell_plain(tile_cols: torch.Tensor, vals: torch.Tensor,
                   local_cols: torch.Tensor, x_tiles: torch.Tensor, *,
                   scheme) -> torch.Tensor:
    """:func:`spmv_ellpack_plain` at G = 1: the same tree over E, slabs
    added in order.  Returns ``acc_dtype[B, R]``."""
    return spmv_ellpack_plain(tile_cols[None], vals[None], local_cols[None],
                              x_tiles[None], scheme=scheme)[0]


def spmv_ell(tile_cols: torch.Tensor, vals: torch.Tensor,
             local_cols: torch.Tensor, x_tiles: torch.Tensor, *,
             scheme) -> torch.Tensor:
    """Single-system banked-ELLPACK SpMV (the port of ``spmv_pallas``).

    ``tile_cols`` int32[B, T], ``vals`` matrix_dtype[B, T, E, R],
    ``local_cols`` int32[B, T, E, R], ``x_tiles`` [n_col_tiles, C] (cast
    to ``spmv_in_dtype`` here).  Returns ``acc_dtype[B, R]``.  On the card
    it is ``csrc/spmv_ellpack.cu`` launched at G = 1, counted apart from
    the batched calls.
    """
    scheme = get_scheme(scheme)
    if on_cpu("spmv_ell", x_tiles):
        return spmv_ell_plain(tile_cols, vals, local_cols, x_tiles,
                              scheme=scheme)
    if tile_cols.dim() != 2 or vals.dim() != 4 or x_tiles.dim() != 2:
        raise ValueError(
            f"spmv_ell: expected tile_cols [B, T], vals [B, T, E, R], "
            f"x_tiles [n_col_tiles, C]; got {tuple(tile_cols.shape)}, "
            f"{tuple(vals.shape)}, {tuple(x_tiles.shape)}")
    y = _launch_ellpack("spmv_ell", tile_cols[None], vals[None],
                        local_cols[None], x_tiles[None], scheme)
    _count("spmv_ell", scheme)
    return y[0]
