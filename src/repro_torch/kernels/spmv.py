"""SpMV kernels for Hopper, each beside its plain PyTorch version.

Two hand-written CUDA C++ kernels (``csrc/``, built by
:mod:`repro_torch.kernels._build` with ``--fmad=false`` for ``sm_90a``)
replace the three Pallas SpMV kernels of the JAX package:

* :func:`spmv_sell` replaces ``repro/kernels/spmv.py::spmv_pallas_sell``
  (batched SELL-C-σ; row-ELL is its one-group case).  A row of width w
  gets min(next_pow2(w), 32) threads whose partial trees fold in shared
  memory, so hub rows of skewed matrices are not one serial chain; x is
  gathered through the read-only cache because an fp64 lane of the main
  path's 2^18 rows (2 MB) cannot sit in a block's shared memory, while a
  bag of lanes fits the 50 MB L2.
* :func:`spmv_ellpack` replaces ``repro/kernels/spmv.py::
  spmv_pallas_batched`` (batched banked ELLPACK).  One block per (lane,
  row block), one thread per row; the slab walk that the TPU ran as a
  sequential grid axis is a loop inside the block, and each slab's x tile
  is staged in shared memory.  At G = 1 the same kernel is
  :func:`spmv_ell`, the port of ``spmv_pallas`` (the single-system
  solver's M1), with a launch count of its own.

Both are bound by bytes on the H100: each stored slot (value + index) is
read once, x gathered, y written once, at 2 flops per slot — the least
time is those bytes over 3.35 TB/s.  Their designs keep the stream at
the scheme's at-rest width (fp32 values under the mixed schemes, int16
indices below 2^15 rows) and keep x reads on chip (L2 / shared memory).

Bracketing is part of the contract: the SELL kernel computes
``rounded_products`` (``v·x + x·0``) and the fixed halving ``tree_sum``
over the width, so it is bitwise equal to its plain version and to the
JAX reference; the ELLPACK kernel fixes the order the reference leaves
to ``jnp.sum`` (tree over E, slabs added in order), equal bitwise to its
plain version and within ``_MV_RTOL`` of JAX.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  :data:`LAUNCHES` counts the
launches of each kernel (one per launch, nowhere else).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core.precision import PrecisionScheme, get_scheme
from repro_torch.kernels._launch import (I, LL, P, check_cuda, function,
                                         on_cpu, raise_on_error)

__all__ = ["spmv_sell", "spmv_sell_plain", "spmv_ellpack",
           "spmv_ellpack_plain", "spmv_ell", "spmv_ell_plain", "LAUNCHES",
           "reset_launches"]

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"spmv_sell": 0, "spmv_ellpack": 0, "spmv_ell": 0}

#: scheme name -> the kernels' template instantiation code.
_SCHEME_CODE = {"fp64": 0, "mixed_v1": 1, "mixed_v2": 2, "mixed_v3": 3}
_INDEX_BYTES = {torch.int16: 2, torch.int32: 4}
#: Width groups one SELL launch carries in its by-value group table.
_GROUPS_PER_LAUNCH = 32


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _scheme_code(scheme: PrecisionScheme) -> int:
    try:
        return _SCHEME_CODE[scheme.name]
    except KeyError:
        raise NotImplementedError(
            f"no CUDA SpMV instantiation for scheme {scheme.name!r}; the "
            f"kernels cover {sorted(_SCHEME_CODE)}") from None


# ------------------------------------------------------------------- SELL
def spmv_sell_plain(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                    *, groups: Sequence[Tuple[int, int]],
                    scheme) -> torch.Tensor:
    """Plain PyTorch SELL SpMV: per width group, gather ``x[g, cols]``,
    :func:`~repro_torch.core.batch.rounded_products`, and
    :func:`~repro_torch.core.batch.tree_sum` over the width.  Returns
    ``acc_dtype[G, n_pad]`` in sorted row order."""
    from repro_torch.core.batch import rounded_products, tree_sum
    scheme = get_scheme(scheme)
    acc = scheme.spmv_acc_dtype
    x_in = x.to(scheme.spmv_in_dtype)
    G = x.shape[0]
    parts, off = [], 0
    for rows, w in groups:
        if w == 0:
            parts.append(torch.zeros((G, rows), dtype=acc, device=x.device))
            continue
        c = cols[:, off:off + rows * w].long()
        v = vals[:, off:off + rows * w].reshape(G, w, rows)
        xg = torch.gather(x_in, 1, c).reshape(G, w, rows)
        parts.append(tree_sum(rounded_products(v, xg, acc), dim=1))
        off += rows * w
    return torch.cat(parts, dim=1)


def spmv_sell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *,
              groups: Sequence[Tuple[int, int]], scheme) -> torch.Tensor:
    """Batched SELL-C-σ SpMV (the port of ``spmv_pallas_sell``).

    ``cols``/``vals`` are the flat slot-major ``[G, L]`` arrays of
    :func:`repro_torch.sparse.stacking.stack_sell` (int16/int32 indices,
    values at ``scheme.matrix_dtype``), ``x`` is ``[G, n_pad]``, ``groups``
    the static ``(rows, width)`` runs (row-ELL: ``((n_pad, W),)`` over the
    flattened ``[G, W, n_pad]`` arrays).  Returns ``acc_dtype[G, n_pad]``
    in **sorted** row order; the caller applies ``iperm`` and the cast to
    ``vector_dtype``.
    """
    scheme = get_scheme(scheme)
    if on_cpu("spmv_sell", x):
        return spmv_sell_plain(cols, vals, x, groups=groups, scheme=scheme)
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
    x_in = x.to(scheme.spmv_in_dtype).contiguous()
    check_cuda("spmv_sell", x.device, cols=cols, vals=vals)
    y = torch.empty((G, n_pad), dtype=scheme.spmv_acc_dtype, device=x.device)
    fn = function("spmv_sell", "spmv_sell",
                  [I, I, P, P, P, P, I, LL, I, I, P, P, P, P, P])
    row0, off, table = 0, 0, []
    for rows, w in groups:
        table.append((row0, rows, w, off))
        row0 += rows
        off += rows * w
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(0, len(table), _GROUPS_PER_LAUNCH):
            part = table[i:i + _GROUPS_PER_LAUNCH]
            n = len(part)
            r0 = (ctypes.c_int * n)(*(t[0] for t in part))
            rs = (ctypes.c_int * n)(*(t[1] for t in part))
            ws = (ctypes.c_int * n)(*(t[2] for t in part))
            os_ = (ctypes.c_longlong * n)(*(t[3] for t in part))
            err = fn(
                code, _INDEX_BYTES[cols.dtype], cols.data_ptr(),
                vals.data_ptr(), x_in.data_ptr(), y.data_ptr(), G, L,
                n_pad, n, r0, rs, ws, os_, stream)
            raise_on_error("spmv_sell", "spmv_sell", err)
            LAUNCHES["spmv_sell"] += 1
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
    LAUNCHES["spmv_ellpack"] += 1
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
    if C * x_in.element_size() > 48 * 1024:
        raise ValueError(f"{name}: a col tile of {C} does not fit "
                         "48 KB of shared memory")
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
    LAUNCHES["spmv_ell"] += 1
    return y[0]
