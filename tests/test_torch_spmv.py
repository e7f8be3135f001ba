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
a skewed and a stencil bag).  The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
