"""The port's batched SpMV (plain PyTorch versions on the CPU) against the
JAX package.

* row-ELL and SELL are **bitwise** equal to the numpy oracle
  ``tests/test_sell.py::_reference_spmv`` (same gather, correctly rounded
  products and halving tree); against JAX's ``batched_matvec_rowell`` /
  ``batched_matvec_sell`` and ``spmv_pallas_sell(interpret=True)`` they
  are expected bitwise and held to the scheme's ``_MV_RTOL``;
* ELLPACK fixes the summation order the reference leaves to ``jnp.sum``,
  so it is held to ``_MV_RTOL`` against ``spmv_pallas_batched``.

Every case runs over the 4 faithful schemes; row-ELL and SELL over int16
and int32 column indices (ELLPACK always stores int32 local columns, over
a skewed and a stencil bag).  The SELL kernel reads each lane at its own
per-slice width (``SellTable``); its plain version given the same table
is held bitwise to the one without and to the oracle, and the table is
checked to cover every row of every lane once.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

import repro.sparse as ref_sparse
from repro.core import batch as ref_batch
from repro.core.precision import get_scheme as ref_get_scheme
from repro.kernels.spmv import spmv_pallas_sell
from repro.sparse.ellpack import csr_to_ellpack as ref_csr_to_ellpack
from repro.sparse.stacking import stack_ellpack as ref_stack_ellpack
from tests.test_backend_diff import _MV_RTOL
from tests.test_sell import _reference_spmv

import repro_torch.sparse as port_sparse
from repro_torch.core import batch
from repro_torch.core.precision import get_scheme
from repro_torch.kernels import spmv as K
from repro_torch.sparse.ellpack import csr_to_ellpack
from repro_torch.sparse.stacking import stack_ellpack, stack_rowell, stack_sell

SCHEMES = ["fp64", "mixed_v1", "mixed_v2", "mixed_v3"]


def _bag(mod, index):
    """int16: bucketed rows < 2^15; int32: one lane crosses it."""
    if index == "int16":
        return [mod.powerlaw_spd(200, alpha=2.1, seed=4),
                mod.diag_dominant_spd(120, nnz_per_row=7, dominance=1.2,
                                      seed=2),
                mod.poisson_2d(8)]
    return [mod.tridiagonal_spd(17000), mod.powerlaw_spd(300, alpha=2.1,
                                                         seed=6)]


def _xs(csrs, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(a.shape[0]) for a in csrs]


def _padded(xs, n_pad):
    out = np.zeros((len(xs), n_pad))
    for g, x in enumerate(xs):
        out[g, : x.shape[0]] = x
    return out


def _assert_mv_close(got, want, scheme):
    """The reference's matvec hold: scaled, rtol = atol = _MV_RTOL."""
    scale = np.abs(want).max() + 1.0
    np.testing.assert_allclose(got / scale, want / scale,
                               rtol=_MV_RTOL[scheme], atol=_MV_RTOL[scheme])


@pytest.mark.parametrize("index", ["int16", "int32"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_rowell_and_sell_plain_match_reference(scheme, index):
    port, ref = _bag(port_sparse, index), _bag(ref_sparse, index)
    sch, rsch = get_scheme(scheme), ref_get_scheme(scheme)
    xs = _xs(port)
    want = _reference_spmv(ref, xs, scheme)

    st_r = stack_rowell(port, scheme=sch)
    assert st_r.cols.dtype == np.dtype(index)
    xp = _padded(xs, st_r.padded_rows)
    x_t = torch.from_numpy(xp)
    y_r = batch.batched_matvec_rowell(torch.from_numpy(st_r.cols),
                                      torch.from_numpy(st_r.vals), x_t,
                                      scheme=sch).numpy()
    st_s = stack_sell(port, scheme=sch)
    y_s = batch.batched_matvec_sell(
        torch.from_numpy(st_s.cols), torch.from_numpy(st_s.vals),
        torch.from_numpy(st_s.iperm).long(), x_t, groups=st_s.groups,
        scheme=sch).numpy()
    for g, (a, w) in enumerate(zip(port, want)):
        n = a.shape[0]
        assert np.array_equal(y_r[g, :n], w), f"row-ELL lane {g}"
        assert np.array_equal(y_s[g, :n], w), f"SELL lane {g}"
    assert np.array_equal(y_r, y_s)

    # JAX's XLA spellings (jitted, as the reference's solvers run them)
    # and the Pallas SELL kernel (interpret mode)
    j_r = np.asarray(jax.jit(partial(ref_batch.batched_matvec_rowell,
                                     scheme=rsch))(
        jnp.asarray(st_r.cols), jnp.asarray(st_r.vals), jnp.asarray(xp)))
    j_s = np.asarray(jax.jit(partial(ref_batch.batched_matvec_sell,
                                     groups=st_s.groups, scheme=rsch))(
        jnp.asarray(st_s.cols), jnp.asarray(st_s.vals),
        jnp.asarray(st_s.iperm), jnp.asarray(xp)))
    y_sorted = spmv_pallas_sell(jnp.asarray(st_s.cols),
                                jnp.asarray(st_s.vals), jnp.asarray(xp),
                                groups=st_s.groups, scheme=rsch,
                                interpret=True)
    j_p = np.asarray(jnp.take_along_axis(
        y_sorted, jnp.asarray(st_s.iperm), axis=1).astype(rsch.vector_dtype))
    for got, jref in ((y_r, j_r), (y_s, j_s), (y_s, j_p)):
        _assert_mv_close(got, jref, scheme)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_sell_kernel_wrapper_matches_plain_on_cpu(scheme):
    """On a CPU tensor the wrapper *is* the plain version (sorted order,
    accumulate dtype)."""
    port = _bag(port_sparse, "int16")
    sch = get_scheme(scheme)
    st = stack_sell(port, scheme=sch)
    x = torch.from_numpy(_padded(_xs(port, 1), st.padded_rows))
    args = (torch.from_numpy(st.cols), torch.from_numpy(st.vals), x)
    y = K.spmv_sell(*args, groups=st.groups, scheme=sch)
    assert y.dtype == sch.spmv_acc_dtype
    assert torch.equal(y, K.spmv_sell_plain(*args, groups=st.groups,
                                            scheme=sch))


def _ellpack_bag(mod, bag):
    if bag == "skewed":
        return [mod.powerlaw_spd(200, alpha=2.1, seed=4),
                mod.diag_dominant_spd(120, nnz_per_row=7, dominance=1.2,
                                      seed=2)]
    return [mod.poisson_2d(12), mod.tridiagonal_spd(150)]


@pytest.mark.parametrize("bag", ["skewed", "stencil"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_ellpack_plain_matches_pallas(scheme, bag):
    """ELLPACK stores int32 local columns whatever the row count."""
    port, ref = _ellpack_bag(port_sparse, bag), _ellpack_bag(ref_sparse, bag)
    sch, rsch = get_scheme(scheme), ref_get_scheme(scheme)
    br, ct = 128, 128
    st = stack_ellpack([csr_to_ellpack(a, block_rows=br, col_tile=ct)
                        for a in port])
    rst = ref_stack_ellpack([ref_csr_to_ellpack(a, block_rows=br,
                                                col_tile=ct) for a in ref])
    xp = _padded(_xs(port, 2), st.padded_rows)
    y = batch.batched_matvec_ellpack(
        torch.from_numpy(st.tile_cols),
        torch.from_numpy(st.vals).to(sch.matrix_dtype),
        torch.from_numpy(st.local_cols), torch.from_numpy(xp),
        col_tile=ct, n_col_tiles=st.n_col_tiles, scheme=sch).numpy()
    j = np.asarray(jax.jit(partial(
        ref_batch.batched_matvec_ellpack, col_tile=ct,
        n_col_tiles=rst.n_col_tiles, scheme=rsch, interpret=True))(
        jnp.asarray(rst.tile_cols),
        jnp.asarray(rst.vals).astype(rsch.matrix_dtype),
        jnp.asarray(rst.local_cols), jnp.asarray(xp)))
    _assert_mv_close(y, j, scheme)


@pytest.mark.parametrize("w", [1, 2, 3, 7, 8, 33, 100])
def test_tree_sum_matches_reference_bitwise(w):
    rng = np.random.default_rng(w)
    p = (rng.standard_normal((5, w, 6))
         * 10.0 ** rng.uniform(-6, 6, (5, w, 6))).astype(np.float32)
    want = ref_batch.tree_sum(p, axis=1)
    got = batch.tree_sum(torch.from_numpy(p), dim=1).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_rounded_products_keep_zero_signs():
    """``v·x + x·0``: a −0 product plus +0 is +0, as in the reference."""
    v = torch.tensor([-1.0, 1.0, -1.0, 0.0])
    x = torch.tensor([0.0, -0.0, -0.0, float("inf")])
    got = batch.rounded_products(v, x, torch.float64)
    want = np.asarray(ref_batch.rounded_products(
        jnp.asarray(v.numpy()), jnp.asarray(x.numpy()), jnp.float64))
    assert np.array_equal(np.signbit(got.numpy()), np.signbit(want))
    assert np.array_equal(got.numpy(), want, equal_nan=True)


def _wide_bag(mod, index):
    """Lanes whose widths differ by 20× or more: a 3-wide stencil beside
    an ~80-wide random lane (int32: the stencil crosses 2^15 rows)."""
    if index == "int16":
        return [mod.tridiagonal_spd(100),
                mod.diag_dominant_spd(120, nnz_per_row=80, dominance=1.2,
                                      seed=5),
                mod.poisson_2d(6)]
    return [mod.tridiagonal_spd(17000),
            mod.diag_dominant_spd(200, nnz_per_row=80, dominance=1.2,
                                  seed=8)]


_SELL_BAGS = {"skewed": _bag, "wide": _wide_bag}


@pytest.mark.parametrize("bag", ["skewed", "wide"])
@pytest.mark.parametrize("index", ["int16", "int32"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_sell_lane_table_plain_matches(scheme, index, bag):
    """Each lane read at its own widths: the plain version with the
    per-lane table equals the one without and the numpy oracle."""
    port = _SELL_BAGS[bag](port_sparse, index)
    ref = _SELL_BAGS[bag](ref_sparse, index)
    sch = get_scheme(scheme)
    st = stack_sell(port, scheme=sch)
    assert st.cols.dtype == np.dtype(index)
    widths = [w for _, w in st.groups if w]
    lane_max = st.lane_widths.max(axis=1)
    if bag == "wide":
        assert lane_max.max() >= 20 * lane_max.min()
    table = K.sell_table(st.groups, device="cpu",
                         lane_widths=st.lane_widths,
                         slice_rows=st.slice_rows)
    assert table.streamed_slots(len(port)) < st.cols.size
    assert max(widths) >= lane_max.max()
    xs = _xs(port, 3)
    x_t = torch.from_numpy(_padded(xs, st.padded_rows))
    args = (torch.from_numpy(st.cols), torch.from_numpy(st.vals), x_t)
    y_lane = K.spmv_sell_plain(*args, groups=st.groups, scheme=sch,
                               table=table)
    y_shared = K.spmv_sell_plain(*args, groups=st.groups, scheme=sch)
    assert y_lane.dtype == y_shared.dtype == sch.spmv_acc_dtype
    assert np.array_equal(y_lane.numpy(), y_shared.numpy())
    assert torch.equal(K.spmv_sell(*args, groups=st.groups, scheme=sch,
                                   table=table), y_lane)
    y = batch.batched_matvec_sell(*args[:2], torch.from_numpy(st.iperm).long(),
                                  x_t, groups=st.groups, scheme=sch,
                                  table=table).numpy()
    for g, (a, w) in enumerate(zip(port, _reference_spmv(ref, xs, scheme))):
        assert np.array_equal(y[g, : a.shape[0]], w), f"lane {g}"


def _check_table(table, groups, lane_widths, slice_rows):
    """Walk the blocks as the kernel does: every sorted row of every lane
    is written by exactly one block, reads its lane's width in its slice
    (never past the stored width) at the group's slot offsets, with S
    threads of next_pow2(w) / S leaves."""
    ent = table.entries.numpy()
    bmap = table.block_map.numpy()
    G, n_slices = lane_widths.shape
    n_pad = sum(r for r, _ in groups)
    row_off = np.zeros(n_pad, np.int64)       # flat slot 0 of each row
    row_stride = np.zeros(n_pad, np.int64)
    stored = np.zeros(n_pad, np.int64)
    r0 = off = 0
    for rows, w in groups:
        row_off[r0:r0 + rows] = off + np.arange(rows)
        row_stride[r0:r0 + rows] = rows
        stored[r0:r0 + rows] = w
        r0 += rows
        off += rows * w
    assert bmap.shape == (G, table.grid_x)
    assert table.grid_x == (bmap >= 0).sum(axis=1).max()
    seen = np.zeros((G, n_pad), np.int64)
    for g in range(G):
        live = bmap[g][bmap[g] >= 0]
        # a lane's blocks come first, then -1 to the end of the grid
        assert (bmap[g, live.size:] == -1).all()
        for b, e in enumerate(bmap[g, :live.size]):
            row0, rows, width, S, block0, base, stride, leaves = ent[e]
            pw = 1 << max(int(width) - 1, 0).bit_length()
            assert S == min(max(pw // K.SELL_MIN_LEAVES, 1),
                            K.SELL_MAX_SUBSETS)
            assert leaves == (pw // S if width else 0)
            rb = 256 // S
            lr = (b - block0) * rb + np.arange(rb)
            lr = lr[lr < rows]
            assert lr.size, "a block with no rows"
            r = row0 + lr
            seen[g, r] += 1
            want = lane_widths[g, r // slice_rows]
            assert (width == want).all() and (width <= stored[r]).all()
            assert (base + lr == row_off[r]).all()
            assert (stride == row_stride[r]).all()
    assert (seen == 1).all()
    assert table.streamed_slots(G) == int(
        (lane_widths.repeat(slice_rows, axis=1)[:, :n_pad]).sum())


@pytest.mark.parametrize("bag", ["skewed", "wide"])
@pytest.mark.parametrize("index", ["int16", "int32"])
def test_sell_table_covers_every_row_once(bag, index):
    port = _SELL_BAGS[bag](port_sparse, index)
    st = stack_sell(port, scheme=get_scheme("mixed_v3"))
    table = K.sell_table(st.groups, device="cpu",
                         lane_widths=st.lane_widths,
                         slice_rows=st.slice_rows)
    assert not table.shared and table.wide == (
        int(table.entries[:, 7].max()) > K.SELL_REG_LEAVES)
    _check_table(table, st.groups, st.lane_widths, st.slice_rows)
    # the shared table reads every lane at the stored widths; its one
    # map row serves every lane
    shared = K.sell_table(st.groups, device="cpu")
    assert shared.shared and shared.block_map.shape[0] == 1
    assert shared.streamed_slots(len(port)) == st.cols.size
    stored = np.array([w for rows, w in st.groups
                       for _ in range(-(-rows // st.slice_rows))])
    per_lane = dataclasses.replace(
        shared, block_map=shared.block_map.expand(len(port), -1))
    _check_table(per_lane, st.groups,
                 np.broadcast_to(stored, st.lane_widths.shape),
                 st.slice_rows)


def test_sell_table_wide_rows_take_the_generic_tree():
    """Rows wider than 32 × SELL_REG_LEAVES slots mark the table wide
    (the kernel's generic-tree instantiation); the plain version reads
    them at their lane width as any other row."""
    n, hubs, w = 2304, 64, 32 * K.SELL_REG_LEAVES + 1
    rows = np.concatenate([np.repeat(np.arange(hubs), w), np.arange(n)])
    cols = np.concatenate([(np.repeat(np.arange(hubs), w)
                            + np.tile(np.arange(w), hubs)) % n, np.arange(n)])
    vals = np.random.default_rng(0).standard_normal(rows.size)
    a = port_sparse.csr_from_coo(rows, cols, vals, (n, n))
    sch = get_scheme("fp64")
    st = stack_sell([a], scheme=sch)
    table = K.sell_table(st.groups, device="cpu", lane_widths=st.lane_widths,
                         slice_rows=st.slice_rows)
    assert table.wide
    assert int(table.entries[:, 7].max()) == 2 * K.SELL_REG_LEAVES
    assert not K.sell_table(((64, 2048),), device="cpu").wide
    x = torch.from_numpy(_padded(_xs([a], 4), st.padded_rows))
    args = (torch.from_numpy(st.cols), torch.from_numpy(st.vals), x)
    assert np.array_equal(
        K.spmv_sell_plain(*args, groups=st.groups, scheme=sch,
                          table=table).numpy(),
        K.spmv_sell_plain(*args, groups=st.groups, scheme=sch).numpy())
