"""CSR to banked ELLPACK on the device (``repro_torch.kernels.pack``): the
plain version against the host path ``pad_ellpack(csr_to_ellpack(a))``
and ``a.diagonal()``, bit for bit, over matrices, blockings, buckets and
schemes; the engine's ELLPACK admissions and the operator build through
it; and, on a card, the CUDA kernel against the plain version (the
``cuda`` tests skip without one: ``python -m pytest --noconftest -m
cuda tests/test_torch_pack.py`` on the card, whose Python has no JAX for
``conftest.py``)."""
import itertools

import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

from repro_torch.core.metrics import (enable_tracing, reset_solver_metrics,
                                      solver_metrics)
from repro_torch.core.precision import get_scheme, values_tensor
from repro_torch.kernels import pack
from repro_torch.kernels.ops import EllKernelOperator, ell_operator_pallas
from repro_torch.serve import SolverEngine, SolverEngineConfig
from repro_torch.sparse.csr import CSRMatrix, csr_from_coo
from repro_torch.sparse.ellpack import csr_to_ellpack
from repro_torch.sparse.generators import poisson_2d
from repro_torch.sparse.stacking import bucket_up, pad_ellpack


def _banded(n, half, seed):
    """Rows with the columns i - half .. i + half (clipped), random values."""
    i = np.repeat(np.arange(n), 2 * half + 1)
    j = i + np.tile(np.arange(-half, half + 1), n)
    keep = (j >= 0) & (j < n)
    vals = np.random.default_rng(seed).standard_normal(int(keep.sum()))
    return csr_from_coo(i[keep], j[keep], vals, (n, n))


def _scrambled(n, per_row, seed):
    """Random columns in no order, each row with a repeated column and a
    repeated diagonal entry (the last one is the diagonal), some rows
    empty."""
    rng = np.random.default_rng(seed)
    indptr, cols = [0], []
    for i in range(n):
        k = int(rng.integers(0, per_row + 1))
        row = list(rng.integers(0, n, size=k))
        if k:
            row += [row[0], i, i]
        cols += row
        indptr.append(len(cols))
    return CSRMatrix(np.array(indptr, np.int64), np.array(cols, np.int32),
                     rng.standard_normal(len(cols)), (n, n))


def _empty_rows(n, seed):
    """A Poisson grid with every third row emptied."""
    a = poisson_2d(int(np.sqrt(n)))
    keep = np.repeat(np.arange(a.n_rows) % 3 != 1, a.row_nnz())
    rows = np.repeat(np.arange(a.n_rows), a.row_nnz())[keep]
    return csr_from_coo(rows, a.indices[keep], a.data[keep], a.shape)


MATRICES = {
    "poisson": lambda: poisson_2d(37),            # n 1,369: ragged blocks
    "banded": lambda: _banded(700, 40, 1),
    "scrambled": lambda: _scrambled(600, 9, 2),
    "empty_rows": lambda: _empty_rows(900, 3),
    "zero_nnz": lambda: CSRMatrix(np.zeros(301, np.int64),
                                  np.zeros(0, np.int32), np.zeros(0),
                                  (300, 300)),
    "one_row": lambda: poisson_2d(1),
}
BLOCKINGS = [(32, 64), (256, 512)]
SCHEMES = ["fp64", "mixed_v1", "mixed_v2", "mixed_v3", "tpu_fp32", "tpu_v3"]
CASES = list(itertools.product(MATRICES, BLOCKINGS, SCHEMES, [False, True]))


def _case_id(case):
    name, (r, c), scheme, bucketed = case
    return f"{name}-{r}x{c}-{scheme}-{'bucket' if bucketed else 'own'}"


def _dims(geometry, bucketed):
    """The matrix's own (B, T, L), or one edge past its bucket's."""
    own = geometry[:3]
    return tuple(bucket_up(d + 1) for d in own) if bucketed else own


def _host(a, block_rows, col_tile, scheme, dims):
    """The host path: ``pad_ellpack(csr_to_ellpack(a))`` copied at the
    scheme's dtypes, and ``a.diagonal()`` padded with ones."""
    m = csr_to_ellpack(a, block_rows=block_rows, col_tile=col_tile)
    geometry = (m.n_row_blocks, m.n_slabs, m.ell, m.n_col_tiles)
    m = pad_ellpack(m, n_row_blocks=dims[0], n_slabs=dims[1], ell=dims[2])
    dg = np.ones(dims[0] * block_rows)
    dg[:a.shape[0]] = a.diagonal()
    return geometry, (torch.from_numpy(m.tile_cols),
                      values_tensor(m.vals, "cpu", scheme.matrix_dtype),
                      torch.from_numpy(m.local_cols),
                      values_tensor(dg, "cpu", scheme.vector_dtype))


def _bits(t):
    """A tensor's bytes, comparable bit for bit (NaNs and zero signs too)."""
    return t.contiguous().view(torch.uint8)


def _same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g.cpu()), _bits(w.cpu()))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_is_the_host_path(case):
    name, (block_rows, col_tile), scheme, bucketed = case
    a, sch = MATRICES[name](), get_scheme(scheme)
    csr = pack.CSRTensors.from_csr(a, "cpu")
    geometry = pack.ellpack_geometry(csr, block_rows=block_rows,
                                     col_tile=col_tile)
    dims = _dims(geometry, bucketed)
    host_geometry, want = _host(a, block_rows, col_tile, sch, dims)
    assert geometry == host_geometry
    # a lane that held another matrix: every element is rewritten
    out = tuple(torch.full_like(t, 7) for t in want)
    got = pack.ellpack_pack(csr, geometry, dims, block_rows=block_rows,
                            col_tile=col_tile,
                            matrix_dtype=sch.matrix_dtype,
                            vector_dtype=sch.vector_dtype, out=out)
    assert all(g is o for g, o in zip(got, out))
    _same_bits(got, want)


def test_values_round_as_the_host_copies_them():
    """Ties, subnormals, overflow, infinities and NaNs of either sign go to
    fp32 and bf16 as the host's casts take them."""
    v = np.array([1 + 2.0 ** -24, 1 + 3 * 2.0 ** -24, 1 + 2.0 ** -8,
                  1 + 3 * 2.0 ** -8, 1e-40, -1e-45, 3.5e38, -1e300,
                  np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0,
                  float.fromhex("0x1.0000010000001p0")])
    n = v.size
    a = CSRMatrix(np.arange(n + 1, dtype=np.int64),
                  np.arange(n, dtype=np.int32), v, (n, n))
    csr = pack.CSRTensors.from_csr(a, "cpu")
    for scheme in ("mixed_v3", "tpu_fp32", "tpu_v1"):
        sch = get_scheme(scheme)
        geometry = pack.ellpack_geometry(csr, block_rows=8, col_tile=4)
        _, want = _host(a, 8, 4, sch, geometry[:3])
        got = pack.ellpack_pack(csr, geometry, geometry[:3], block_rows=8,
                                col_tile=4, matrix_dtype=sch.matrix_dtype,
                                vector_dtype=sch.vector_dtype)
        _same_bits(got, want)


def test_dims_below_the_geometry_raise():
    csr = pack.CSRTensors.from_csr(poisson_2d(20), "cpu")
    geometry = pack.ellpack_geometry(csr, block_rows=32, col_tile=64)
    B, T, L, _ = geometry
    for dims in ((B - 1, T, L), (B, T - 1, L), (B, T, L - 1)):
        with pytest.raises(ValueError, match="do not hold"):
            pack.ellpack_pack(csr, geometry, dims, block_rows=32,
                              col_tile=64)


@pytest.mark.parametrize("scheme", ["fp64", "mixed_v3", "tpu_v3"])
@pytest.mark.parametrize("given_diag", [False, True])
def test_operator_build_is_the_host_path(scheme, given_diag):
    a = _scrambled(500, 7, 5)
    diag = np.linspace(1.0, 2.0, a.n_rows) if given_diag else None
    reset_solver_metrics()
    enable_tracing(True)
    try:
        op = ell_operator_pallas(a, scheme, diag=diag, block_rows=32,
                                 col_tile=64, device="cpu")
        assert solver_metrics().get("device_packs") == 1
    finally:
        enable_tracing(False)
        reset_solver_metrics()
    want = EllKernelOperator.from_ellpack(
        csr_to_ellpack(a, block_rows=32, col_tile=64), scheme,
        a.diagonal() if diag is None else diag, "cpu")
    for field in ("tile_cols", "vals", "local_cols", "diag"):
        _same_bits([getattr(op, field)], [getattr(want, field)])
    for field in ("n", "block_rows", "col_tile", "padded_cols", "nnz"):
        assert getattr(op, field) == getattr(want, field)


# ------------------------------------------------------------------ engine
BK = dict(block_rows=32, col_tile=64)


def _engine(**kw):
    cfg = dict(batch_slots=2, chunk_iters=16, backend="pallas",
               layout="ellpack", compact_fraction=0.0, device="cpu", **BK)
    cfg.update(kw)
    return SolverEngine(SolverEngineConfig(**cfg))


def _spd_banded(n, half):
    """Symmetric, diagonally dominant: its band's entries are −1/(2 half)."""
    i = np.repeat(np.arange(n), 2 * half + 1)
    j = i + np.tile(np.arange(-half, half + 1), n)
    keep = (j >= 0) & (j < n)
    v = np.where(i == j, 2.0, -1.0 / (2 * half))[keep]
    return csr_from_coo(i[keep], j[keep], v, (n, n))


def _rhs(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def test_readmitted_narrow_lane_is_a_fresh_one():
    """A slot whose last occupant was wider (more slabs and slots) packs
    the narrow matrix over every element: its lane is the host path's at
    the pool's bucket, and the solve is bit for bit the narrow matrix's
    beside the wide one in a fresh engine of the same bucket."""
    wide, narrow = _spd_banded(700, 80), poisson_2d(20)
    bw, bn = _rhs(700, 1), _rhs(400, 2)
    used = _engine()
    used.submit(wide, bw)
    used.run_to_completion()
    rid = used.submit(narrow, bn)
    pool = next(iter(used._pools.values()))
    assert pool.req_of_slot[0] == rid                  # the wide one's slot
    B, T, L, _ = pool.bucket
    _, want = _host(narrow, 32, 64, get_scheme("mixed_v3"), (B, T, L))
    _same_bits([arr[0] for arr in pool.mats[0]], want[:3])
    got = used.run_to_completion()[rid]

    fresh = _engine()
    fresh.submit(wide, bw)
    rid_f = fresh.submit(narrow, bn)
    assert next(iter(fresh._pools.values())).bucket == pool.bucket
    want_res = fresh.run_to_completion()[rid_f]
    assert got.status == want_res.status == "CONVERGED"
    assert got.iterations == want_res.iterations
    assert torch.equal(_bits(got.x), _bits(want_res.x))


@pytest.mark.parametrize("layout,backend,packs", [
    ("ellpack", "pallas", True), ("auto", "pallas", True),
    ("sell", "pallas", False), ("rowell", "xla", False)])
def test_device_packs_count_ellpack_admissions(layout, backend, packs):
    enable_tracing(True)
    try:
        eng = _engine(batch_slots=4, layout=layout, backend=backend)
        for n in (6, 9, 12):
            eng.submit(poisson_2d(n), _rhs(n * n, n))
        eng.run_to_completion()
        snap = eng.metrics()
    finally:
        enable_tracing(False)
    assert snap["submit.n"] == 3
    assert snap.get("device_packs", 0) == (3 if packs else 0)
    if packs:
        # the CSR and b (fp64) cross the bus, not the padded lane
        sizes = [poisson_2d(n) for n in (6, 9, 12)]
        csr_bytes = sum(8 * (a.n_rows + 1) + 12 * a.nnz + 8 * a.n_rows
                        for a in sizes)
        assert snap["h2d_bytes"] == csr_bytes


# --------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel runs only there")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kernel_is_the_plain_version(card, case):
    name, (block_rows, col_tile), scheme, bucketed = case
    a, sch = MATRICES[name](), get_scheme(scheme)
    kw = dict(block_rows=block_rows, col_tile=col_tile)
    plain_csr = pack.CSRTensors.from_csr(a, "cpu")
    geometry = pack.ellpack_geometry_plain(plain_csr, **kw)
    dims = _dims(geometry, bucketed)
    want = pack.ellpack_pack_plain(
        plain_csr, geometry, dims, matrix_dtype=sch.matrix_dtype,
        vector_dtype=sch.vector_dtype, **kw)
    csr = pack.CSRTensors.from_csr(a, card)
    assert pack.ellpack_geometry(csr, **kw) == geometry
    out = tuple(torch.full_like(t, 7, device=card) for t in want)
    got = pack.ellpack_pack(csr, geometry, dims, matrix_dtype=sch.matrix_dtype,
                            vector_dtype=sch.vector_dtype, out=out, **kw)
    torch.cuda.synchronize()
    _same_bits(got, want)
