"""The single-system solver's kernels in the port (plain PyTorch versions
on the CPU) against the JAX package's Pallas kernels in interpret mode.

* ``spmv_ell_plain`` against ``spmv_pallas`` over the 4 faithful schemes,
  at the reference's ``_MV_RTOL`` (the port fixes the order over E that
  the reference leaves to ``jnp.sum``);
* ``dot``, ``dot3``, ``phase2`` and ``phase3`` (CPU path) against
  ``dot_pallas``, ``dot3_pallas``, ``phase2_pallas`` and ``phase3_pallas``
  for fp32 and fp64 at rtol 1e-5 / 1e-12, relative to the magnitudes of
  the terms: a sum is taken in another order than the TPU tile's, and the
  reference may contract ``r − α·ap`` into one rounding, so each result
  is held to rtol times the sum of its terms' magnitudes;
* the port's chunked tree is a composition of ``batch.tree_sum``, bit for
  bit, and a step-by-step numpy model of ``csrc/reduce.cuh`` (the order in
  which the CUDA kernels add) lands on the same bits.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as ref_sparse
from repro.core import batch as ref_batch
from repro.core.precision import get_scheme as ref_get_scheme
from repro.kernels.dot import dot3_pallas, dot_pallas
from repro.kernels.fused_phase import phase2_pallas, phase3_pallas
from repro.kernels.ops import ell_operator_pallas as ref_ell_operator
from repro.kernels.spmv import spmv_pallas
from repro.sparse.ellpack import csr_to_ellpack as ref_csr_to_ellpack
from tests.test_backend_diff import _MV_RTOL

import repro_torch.sparse as port_sparse
from repro_torch import convert
from repro_torch.core import batch
from repro_torch.core.precision import get_scheme
from repro_torch.kernels import dot as D
from repro_torch.kernels import fused_phase as F
from repro_torch.kernels import ops
from repro_torch.kernels import spmv as K
from repro_torch.sparse.ellpack import csr_to_ellpack

SCHEMES = ["fp64", "mixed_v1", "mixed_v2", "mixed_v3"]
RTOL = {np.float32: 1e-5, np.float64: 1e-12}
#: ragged lengths around the port's chunk (2048) and the TPU tile (4096)
NS = [1, 7, 300, 2049, 4097]


def _mat(mod, which):
    if which == "stencil":
        return mod.poisson_2d(12)
    return mod.diag_dominant_spd(300, nnz_per_row=9, dominance=1.2, seed=5)


def _assert_mv_close(got, want, scheme):
    """The reference's matvec hold: scaled, rtol = atol = _MV_RTOL."""
    scale = np.abs(want).max() + 1.0
    np.testing.assert_allclose(got / scale, want / scale,
                               rtol=_MV_RTOL[scheme], atol=_MV_RTOL[scheme])


def _assert_sum_close(got, want, terms, dtype):
    """|got − want| ≤ rtol · Σ|terms| over the last axis of ``terms``: the
    error two summation orders (or a contracted and an uncontracted
    multiply-add) may differ by."""
    bound = RTOL[dtype] * np.abs(terms).sum(axis=-1)
    assert np.all(np.abs(np.asarray(got, np.float64)
                         - np.asarray(want, np.float64)) <= bound), (
        got, want, bound)


@pytest.mark.parametrize("which", ["stencil", "skewed"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_spmv_ell_plain_matches_pallas(scheme, which):
    sch, rsch = get_scheme(scheme), ref_get_scheme(scheme)
    a = _mat(port_sparse, which)
    m = csr_to_ellpack(a, block_rows=128, col_tile=128)
    rm = ref_csr_to_ellpack(_mat(ref_sparse, which), block_rows=128,
                            col_tile=128)
    assert np.array_equal(m.vals, rm.vals)
    x = np.random.default_rng(3).standard_normal(m.padded_cols)
    x_tiles = x.reshape(-1, m.col_tile)
    args = (torch.from_numpy(m.tile_cols),
            torch.from_numpy(m.vals).to(sch.matrix_dtype),
            torch.from_numpy(m.local_cols), torch.from_numpy(x_tiles))
    K.reset_launches()
    y = K.spmv_ell_plain(*args, scheme=sch)
    assert y.shape == (m.n_row_blocks, m.block_rows)
    assert y.dtype == sch.spmv_acc_dtype
    assert torch.equal(K.spmv_ell(*args, scheme=sch), y)
    assert K.LAUNCHES["spmv_ell"] == 0
    want = spmv_pallas(jnp.asarray(rm.tile_cols),
                       jnp.asarray(rm.vals).astype(rsch.matrix_dtype),
                       jnp.asarray(rm.local_cols), jnp.asarray(x_tiles),
                       scheme=rsch, interpret=True)
    _assert_mv_close(y.numpy(), np.asarray(want), scheme)


@pytest.mark.parametrize("scheme", ["fp64", "mixed_v1"])
def test_kernel_operator_matches_pallas_operator(scheme):
    """The operators around the SpMV: x padded to whole tiles, the rows
    cut to n and cast to ``vector_dtype``, also after ``convert``."""
    a = _mat(port_sparse, "skewed")
    ref_op = ref_ell_operator(_mat(ref_sparse, "skewed"), scheme,
                              block_rows=128, col_tile=128, interpret=True)
    op = ops.ell_operator_pallas(a, scheme, block_rows=128, col_tile=128,
                                 device="cpu")
    op_c = convert.operator_to_torch(ref_op, device="cpu")
    x = np.random.default_rng(4).standard_normal(a.shape[0])
    want = np.asarray(ref_op.matvec(jnp.asarray(x)))
    for o in (op, op_c):
        got = o.matvec(torch.from_numpy(x))
        assert got.dtype == torch.float64 and got.shape == (a.shape[0],)
        _assert_mv_close(got.numpy(), want, scheme)
    assert torch.equal(op.vals, op_c.vals)
    assert torch.equal(op.diag, op_c.diag)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dot_matches_pallas(n, dtype):
    r = np.random.default_rng(n)
    a, b = (r.standard_normal(n).astype(dtype) for _ in range(2))
    got = D.dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == () and got.dtype == torch.from_numpy(a).dtype
    assert torch.equal(got, D.dot_plain(torch.from_numpy(a),
                                        torch.from_numpy(b)))
    want = dot_pallas(jnp.asarray(a), jnp.asarray(b), acc_dtype=dtype,
                      interpret=True)
    _assert_sum_close(got.numpy(), want, a.astype(np.float64) * b, dtype)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dot3_matches_pallas(n, dtype):
    g = np.random.default_rng(10 + n)
    r, u, w = (g.standard_normal(n).astype(dtype) for _ in range(3))
    got = D.dot3(*(torch.from_numpy(v) for v in (r, u, w)))
    assert got.shape == (3,)
    assert torch.equal(got, ops.make_dot3()(*(torch.from_numpy(v)
                                              for v in (r, u, w))))
    want = dot3_pallas(jnp.asarray(r), jnp.asarray(u), jnp.asarray(w),
                       acc_dtype=dtype, interpret=True)
    r64, u64, w64 = (v.astype(np.float64) for v in (r, u, w))
    _assert_sum_close(got.numpy(), want,
                      np.stack([r64 * u64, w64 * u64, r64 * r64]), dtype)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_phase2_matches_pallas(n, dtype):
    g = np.random.default_rng(20 + n)
    r, ap = (g.standard_normal(n).astype(dtype) for _ in range(2))
    dg = (g.random(n) + 0.5).astype(dtype)
    alpha = dtype(0.37)
    rn, s = F.phase2(torch.tensor(alpha), *(torch.from_numpy(v)
                                            for v in (r, ap, dg)))
    assert rn.dtype == torch.from_numpy(r).dtype and s.shape == (2,)
    rn_j, s_j = phase2_pallas(jnp.asarray(alpha), jnp.asarray(r),
                              jnp.asarray(ap), jnp.asarray(dg),
                              interpret=True)
    r64, ap64 = r.astype(np.float64), ap.astype(np.float64)
    _assert_sum_close(rn.numpy(), rn_j, np.stack([r64, 0.37 * ap64], -1),
                      dtype)
    rn64 = rn.numpy().astype(np.float64)
    _assert_sum_close(s.numpy(), s_j,
                      np.stack([rn64 * rn64, rn64 * rn64 / dg]), dtype)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_phase3_matches_pallas(n, dtype):
    g = np.random.default_rng(30 + n)
    rn, p, x = (g.standard_normal(n).astype(dtype) for _ in range(3))
    dg = (g.random(n) + 0.5).astype(dtype)
    alpha, beta = dtype(0.3), dtype(0.7)
    pn, xn = F.phase3(torch.tensor(alpha), torch.tensor(beta),
                      *(torch.from_numpy(v) for v in (rn, dg, p, x)))
    pn_j, xn_j = phase3_pallas(jnp.asarray(alpha), jnp.asarray(beta),
                               jnp.asarray(rn), jnp.asarray(dg),
                               jnp.asarray(p), jnp.asarray(x),
                               interpret=True)
    z, p64, x64 = rn.astype(np.float64) / dg, p.astype(np.float64), x
    for got, want, terms in ((pn, pn_j, [z, 0.7 * p64]),
                             (xn, xn_j, [x64, 0.3 * p64])):
        assert got.dtype == torch.from_numpy(rn).dtype
        _assert_sum_close(got.numpy(), want, np.stack(terms, -1), dtype)


@pytest.mark.parametrize("n", [1, 2, 2047, 2048, 2049, 4095, 4097, 10007])
def test_padding_is_exact_and_finite(n):
    """+0 padding and bounds checks: ones·ones is n exactly, and phase 2
    on a ragged tail gives no NaN (no 0/0 from padded diag entries)."""
    one = torch.ones(n, dtype=torch.float64)
    assert float(D.dot(one, one)) == float(n)
    assert D.dot3(one, one, one).tolist() == [float(n)] * 3
    rn, s = F.phase2(torch.tensor(1.0, dtype=torch.float64), one, one,
                     torch.full((n,), 2.0, dtype=torch.float64))
    assert torch.isfinite(s).all() and s.tolist() == [0.0, 0.0]
    assert torch.equal(rn, torch.zeros(n, dtype=torch.float64))


def _ref_chunk_tree(p):
    """The chunked tree spelled with the reference's ``tree_sum``."""
    nb = max(1, -(-p.shape[-1] // D.CHUNK))
    pad = np.zeros(p.shape[:-1] + (nb * D.CHUNK,), p.dtype)
    pad[..., : p.shape[-1]] = p
    part = ref_batch.tree_sum(pad.reshape(p.shape[:-1] + (nb, D.CHUNK)),
                              axis=-1)
    return np.asarray(ref_batch.tree_sum(part, axis=-1))


def _stack_tree(leaf, w):
    """``tree_sum.cuh``: bit-reversed leaf order, binary-counter stack."""
    logw = max(w - 1, 0).bit_length()
    wp = 1 << logw
    stk = []
    for k in range(wp):
        j = int(format(k, f"0{logw}b")[::-1], 2) if logw else 0
        v = leaf(j) if j < w else np.zeros_like(leaf(0))
        m = k + 1
        while m & 1 == 0:
            v = stk.pop() + v
            m >>= 1
        stk.append(v)
    return stk[0]


def _block_tree(v, width):
    """``block_tree``: threads t and t + s, s halving from width / 2."""
    v = v.copy()
    s = width // 2
    while s > 0:
        v[..., :s] = v[..., :s] + v[..., s:2 * s]
        s //= 2
    return v[..., 0]


def _cuda_model(p):
    """``reduce.cuh`` step by step: 256 threads × 8 leaves per chunk (leaf
    t + 256 k in thread t's slot k), ``fold_items``, ``block_tree``; then
    ``tree_finish`` over the chunk sums."""
    T, I = 256, D.CHUNK // 256
    n = p.shape[-1]
    nb = max(1, -(-n // D.CHUNK))
    pad = np.zeros(nb * D.CHUNK, p.dtype)
    pad[:n] = p
    v = pad.reshape(nb, I, T).copy()           # [block, slot k, thread t]
    s = I // 2
    while s > 0:
        v[:, :s] = v[:, :s] + v[:, s:2 * s]
        s //= 2
    part = _block_tree(v[:, 0], T)             # [nb]
    wp = 1 << max(nb - 1, 0).bit_length()
    if wp >= T:
        lanes = np.zeros(wp, p.dtype)
        lanes[:nb] = part
        held = _stack_tree(lambda k: lanes[k * T:(k + 1) * T], wp // T)
        return _block_tree(held, T)
    held = np.zeros(T, p.dtype)
    held[:nb] = part
    return _block_tree(held, wp)


@pytest.mark.parametrize("n", [1, 5, 2047, 2049, 4095, 4097, 65537,
                               257 * 2048 + 3, 1001 * 2048 + 1])
def test_chunk_tree_is_tree_sum_and_cuda_order(n):
    """Wide dynamic range at fp32 so that any other order shows."""
    g = np.random.default_rng(n)
    p = (g.standard_normal(n) * 10.0 ** g.uniform(-6, 6, n)).astype(
        np.float32)
    got = D.chunk_tree(torch.from_numpy(p)).numpy()
    assert np.array_equal(got, _ref_chunk_tree(p))
    assert np.array_equal(got, _cuda_model(p))
    # and over a leading axis, as dot3 and phase 2 use it
    q = np.stack([p, -p[::-1], p * 0.5])
    got3 = D.chunk_tree(torch.from_numpy(q)).numpy()
    assert np.array_equal(got3, _ref_chunk_tree(q))
    assert np.array_equal(got3, [_cuda_model(row) for row in q])


def test_phase_ops_on_cpu_are_the_plain_versions():
    """``make_phase_ops`` on CPU tensors runs the plain versions and
    launches nothing."""
    g = np.random.default_rng(0)
    r, ap, p, x = (torch.from_numpy(g.standard_normal(500))
                   for _ in range(4))
    dg = torch.from_numpy(g.random(500) + 0.5)
    alpha, beta = torch.tensor(0.25, dtype=torch.float64), torch.tensor(
        0.5, dtype=torch.float64)
    ops.reset_launches()
    dot, phase2, phase3 = ops.make_phase_ops()
    assert torch.equal(dot(p, ap), D.dot_plain(p, ap))
    rn, s = phase2(alpha, r, ap, dg)
    rn_p, s_p = F.phase2_plain(alpha, r, ap, dg)
    assert torch.equal(rn, rn_p) and torch.equal(s, s_p)
    assert torch.equal(rn, r - alpha * ap)
    pn, xn = phase3(alpha, beta, rn, dg, p, x)
    assert torch.equal(pn, rn / dg + beta * p)
    assert torch.equal(xn, x + alpha * p)
    assert set(ops.launches().values()) == {0}
    assert set(ops.launches()) == {"spmv_sell", "spmv_ellpack", "spmv_ell",
                                   "dot", "dot3", "phase2", "phase3"}
    # the chunked sums agree with batch.tree_sum spelled by hand
    prod = torch.stack([rn * rn, rn * (rn / dg)])
    assert torch.equal(s, D.chunk_tree(prod))
    assert torch.equal(D.dot_plain(p, ap),
                       batch.tree_sum(torch.cat(
                           [p * ap, torch.zeros(2048 - 500,
                                                dtype=torch.float64)]),
                           dim=0))
