"""The TPU tier (``tpu_fp32``, ``tpu_v1..v3``: bf16 values at rest, fp32
vectors) in the port, against the JAX package.

* Packing is byte-identical to the reference: bf16 values compared as
  their ``uint16`` bits, indices, permutations, groups and lane widths as
  they are at the faithful schemes.
* The SpMVs' plain versions equal the numpy oracle
  (``tests/test_sell.py::_reference_spmv``, whose ``ml_dtypes`` bf16 rounds
  each product and sum as eager PyTorch does) bit for bit, and are held
  to the reference's Pallas kernels (interpret mode) within the
  reference's own ``_tol`` (``tests/test_kernels.py``): 2e-5 at an fp32
  accumulator, 2e-1 at bf16 (``tpu_v1``), on values scaled by
  ``max|y| + 1``.  XLA on the CPU may keep a bf16 chain at fp32, so the
  reference is not expected bitwise.
* Solves: the same statuses and iterations within ±1 of the reference's
  phases engine at ``tpu_fp32`` and ``tpu_v3``; x within ``rtol=1e-3,
  atol=1e-4`` (fp32 vectors).  The single-system solver is held against
  the reference's ``pallas`` run: its ``xla`` run stops at another
  iteration (22 against 19 at ``tpu_fp32`` on ``poisson_2d(12)``).
  ``tpu_v1`` accumulates in bf16, and the reference's own two backends
  part there: its solves are held within the larger of 2 and the
  reference's xla-vs-pallas spread on the same problem.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

import repro.sparse as ref_sparse
from repro.core import batch as ref_batch
from repro.core.batch import jpcg_solve_batched as ref_solve
from repro.core.cg import jpcg_solve as ref_jpcg_solve
from repro.core.precision import get_scheme as ref_get_scheme
from repro.kernels.ops import ell_operator_pallas as ref_ell_operator
from repro.kernels.spmv import spmv_pallas, spmv_pallas_sell
from repro.serve.solver_engine import (SolverEngine as RefEngine,
                                       SolverEngineConfig as RefConfig)
from repro.sparse.ellpack import csr_to_ellpack as ref_csr_to_ellpack
from repro.sparse.stacking import (stack_ellpack as ref_stack_ellpack,
                                   stack_rowell as ref_stack_rowell,
                                   stack_sell as ref_stack_sell)
from tests.test_sell import _reference_spmv
from tests.test_torch_host import _bags
from tests.test_torch_solver_engine import _requests, _run

import repro_torch.sparse as port_sparse
from repro_torch import convert
from repro_torch.core import batch
from repro_torch.core.batch import jpcg_solve_batched, stack_operands
from repro_torch.core.cg import jpcg_solve
from repro_torch.core.precision import (BF16_CARRIER, bf16_bits, get_scheme,
                                        values_tensor)
from repro_torch.device import to_device
from repro_torch.kernels import ops
from repro_torch.kernels import spmv as K
from repro_torch.serve import SolverEngine, SolverEngineConfig
from repro_torch.sparse.ellpack import csr_to_ellpack
from repro_torch.sparse.stacking import stack_ellpack, stack_rowell, stack_sell

TIER = ["tpu_fp32", "tpu_v1", "tpu_v2", "tpu_v3"]
BK = dict(block_rows=128, col_tile=128)
#: the reference's kernel tolerance (tests/test_kernels.py::_tol)
_TOL = {"float64": 1e-12, "float32": 2e-5, "bfloat16": 2e-1}
#: x of a tier solve against the reference's (fp32 vectors)
X_RTOL, X_ATOL = 1e-3, 1e-4
SOLVE_TOL = 1e-8


def _bits(a) -> np.ndarray:
    """Values as the port carries them: bf16 as uint16 bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(BF16_CARRIER)
        return a.numpy()
    a = np.asarray(a)
    return a.view(BF16_CARRIER) if a.dtype.name == "bfloat16" else a


def _equal(got, want):
    got, want = _bits(got), _bits(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want)


def _scaled_close(got, want, acc_name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    tol = _TOL[acc_name]
    scale = np.abs(want).max() + 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol,
                               atol=tol)


def _acc(scheme) -> str:
    return str(get_scheme(scheme).spmv_acc_dtype).split(".")[-1]


# ---------------------------------------------------------------- packing
def test_bf16_bits_round_as_the_reference():
    """Round-to-nearest-even through fp32, NaN and ±inf kept: the bits of
    ``astype(jnp.bfloat16)`` on values next to bf16 ties and across the
    range; the device tensor carries the same bits."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal(4000).astype(jnp.bfloat16).astype(np.float64)
    half = 1.0 + 2.0 ** -8                     # a tie between bf16 neighbours
    x = np.concatenate([
        rng.standard_normal(4000) * 10.0 ** rng.integers(-30, 30, 4000),
        base * half, base * half * (1 + 1e-12), base * half * (1 - 1e-12),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 3.4e38, 3.5e38, 1e-40,
         -1e-45, 1 + 2.0 ** -8 + 2.0 ** -40]])
    with np.errstate(over="ignore"):       # 3.5e38 is beyond bf16: inf
        want = x.astype(jnp.bfloat16).view(np.uint16)
        ref_bf16 = x.astype(jnp.bfloat16)
    got = bf16_bits(x)
    assert got.dtype == BF16_CARRIER
    assert np.array_equal(got, want)
    for t in (values_tensor(x, "cpu", torch.bfloat16),
              to_device(x, "cpu", torch.bfloat16),
              to_device(ref_bf16, "cpu")):
        assert t.dtype == torch.bfloat16
        assert np.array_equal(_bits(t), want)
    assert to_device(np.float64(1.5), "cpu", torch.bfloat16).dim() == 0


@pytest.mark.parametrize("scheme", TIER)
@pytest.mark.parametrize("bag", ["skewed", "uniform", "int32"])
def test_stack_rowell_and_sell_match_at_tier(scheme, bag):
    port, ref = _bags(port_sparse)[bag], _bags(ref_sparse)[bag]
    sch, rsch = get_scheme(scheme), ref_get_scheme(scheme)
    p, r = stack_rowell(port, scheme=sch), ref_stack_rowell(ref, scheme=rsch)
    assert p.vals.dtype == sch.host_matrix_dtype
    _equal(p.cols, r.cols)
    _equal(p.vals, r.vals)
    p, r = stack_sell(port, scheme=sch), ref_stack_sell(ref, scheme=rsch)
    _equal(p.cols, r.cols)
    _equal(p.vals, r.vals)
    _equal(p.iperm, r.iperm)
    assert p.groups == r.groups
    # the port's lane widths do not depend on the value dtype
    _equal(p.lane_widths,
           stack_sell(port, scheme=get_scheme("mixed_v3")).lane_widths)


@pytest.mark.parametrize("scheme", TIER)
@pytest.mark.parametrize("bag", ["skewed", "uniform"])
def test_stack_ellpack_values_match_at_tier(scheme, bag):
    """ELLPACK stacks at the CSR's dtype; the operand on the device holds
    the reference's ``astype(matrix_dtype)`` bits."""
    port, ref = _bags(port_sparse)[bag], _bags(ref_sparse)[bag]
    sch, rsch = get_scheme(scheme), ref_get_scheme(scheme)
    mat, stacked, _, _, _ = stack_operands(
        port, backend="pallas", layout="ellpack", scheme=sch, device="cpu",
        block_rows=32, col_tile=64)
    r = ref_stack_ellpack([ref_csr_to_ellpack(a, block_rows=32, col_tile=64)
                           for a in ref])
    assert mat[1].dtype == sch.matrix_dtype
    _equal(mat[1], np.asarray(jnp.asarray(r.vals).astype(rsch.matrix_dtype)))
    _equal(mat[0], r.tile_cols)
    _equal(mat[2], r.local_cols)


@pytest.mark.parametrize("scheme", TIER)
def test_convert_reads_reference_bf16(scheme):
    """The reference's bf16 arrays (``ml_dtypes``) arrive as the port's
    own operands, bit for bit: a stacked SELL bag and a single-system
    ELLPACK operator."""
    sch, rsch = get_scheme(scheme), ref_get_scheme(scheme)
    port, ref = _bags(port_sparse)["skewed"], _bags(ref_sparse)["skewed"]
    got = convert.stacked_to_torch(ref_stack_sell(ref, scheme=rsch),
                                   device="cpu")
    want, *_ = stack_operands(port, backend="xla", layout="sell",
                              scheme=sch, device="cpu")
    assert got[1].dtype == sch.matrix_dtype
    for g, w in zip(got[:3], want[:3]):
        _equal(g, w)
    ref_op = ref_ell_operator(ref[0], rsch, block_rows=32, col_tile=64,
                              interpret=True)
    op = convert.operator_to_torch(ref_op, device="cpu")
    mine = ops.ell_operator_pallas(port[0], scheme, block_rows=32,
                                   col_tile=64, device="cpu")
    assert op.vals.dtype == sch.matrix_dtype
    _equal(op.vals, mine.vals)


# ------------------------------------------------------------------ SpMV
def _spmv_bag(mod, index):
    if index == "int16":
        return [mod.powerlaw_spd(200, alpha=2.1, seed=4),
                mod.diag_dominant_spd(120, nnz_per_row=7, dominance=1.2,
                                      seed=2),
                mod.poisson_2d(8)]
    return [mod.tridiagonal_spd(17000), mod.powerlaw_spd(300, alpha=2.1,
                                                         seed=6)]


def _padded(xs, n_pad):
    out = np.zeros((len(xs), n_pad))
    for g, x in enumerate(xs):
        out[g, : x.shape[0]] = x
    return out


@pytest.mark.parametrize("index", ["int16", "int32"])
@pytest.mark.parametrize("scheme", TIER)
def test_rowell_and_sell_at_tier(scheme, index):
    """Row-ELL and SELL (each lane at its own widths) against the numpy
    oracle bit for bit, and against the reference's jitted row-ELL matvec
    and its Pallas SELL kernel within ``_tol``."""
    port, ref = _spmv_bag(port_sparse, index), _spmv_bag(ref_sparse, index)
    sch, rsch = get_scheme(scheme), ref_get_scheme(scheme)
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal(a.shape[0]) for a in port]
    oracle = _reference_spmv(ref, xs, scheme)

    st_r = stack_rowell(port, scheme=sch)
    assert st_r.cols.dtype == np.dtype(index)
    xp = _padded(xs, st_r.padded_rows)
    x_t = torch.from_numpy(xp).to(sch.vector_dtype)
    y_r = batch.batched_matvec_rowell(
        torch.from_numpy(st_r.cols), values_tensor(st_r.vals, "cpu",
                                                   sch.matrix_dtype),
        x_t, scheme=sch).numpy()
    st_s = stack_sell(port, scheme=sch)
    table = K.sell_table(st_s.groups, device="cpu",
                         lane_widths=st_s.lane_widths,
                         slice_rows=st_s.slice_rows)
    y_s = batch.batched_matvec_sell(
        torch.from_numpy(st_s.cols),
        values_tensor(st_s.vals, "cpu", sch.matrix_dtype),
        torch.from_numpy(st_s.iperm).long(), x_t, groups=st_s.groups,
        scheme=sch, table=table).numpy()
    for g, (a, w) in enumerate(zip(port, oracle)):
        n = a.shape[0]
        assert np.array_equal(y_r[g, :n], w), f"row-ELL lane {g}"
        assert np.array_equal(y_s[g, :n], w), f"SELL lane {g}"

    xj = jnp.asarray(xp, rsch.vector_dtype)
    r_r = ref_stack_rowell(ref, scheme=rsch)
    j_r = np.asarray(jax.jit(lambda c, v, x: ref_batch.batched_matvec_rowell(
        c, v, x, scheme=rsch))(jnp.asarray(r_r.cols), jnp.asarray(r_r.vals),
                               xj))
    r_s = ref_stack_sell(ref, scheme=rsch)
    y_sorted = spmv_pallas_sell(jnp.asarray(r_s.cols), jnp.asarray(r_s.vals),
                                xj, groups=r_s.groups, scheme=rsch,
                                interpret=True)
    j_p = np.asarray(jnp.take_along_axis(
        y_sorted, jnp.asarray(r_s.iperm), axis=1).astype(rsch.vector_dtype))
    _scaled_close(y_r, j_r, _acc(scheme))
    _scaled_close(y_s, j_p, _acc(scheme))


@pytest.mark.parametrize("bag", ["skewed", "stencil"])
@pytest.mark.parametrize("scheme", TIER)
def test_ellpack_at_tier(scheme, bag):
    """Batched ELLPACK against ``spmv_pallas_batched`` (interpret mode),
    and its G = 1 form ``spmv_ell`` against ``spmv_pallas``, within
    ``_tol``; int32 local columns whatever the row count."""
    mk = {"skewed": lambda m: [m.powerlaw_spd(200, alpha=2.1, seed=4),
                               m.diag_dominant_spd(120, nnz_per_row=7,
                                                   dominance=1.2, seed=2)],
          "stencil": lambda m: [m.poisson_2d(12), m.tridiagonal_spd(150)]}
    port, ref = mk[bag](port_sparse), mk[bag](ref_sparse)
    sch, rsch = get_scheme(scheme), ref_get_scheme(scheme)
    br, ct = 128, 128
    st = stack_ellpack([csr_to_ellpack(a, block_rows=br, col_tile=ct)
                        for a in port])
    rst = ref_stack_ellpack([ref_csr_to_ellpack(a, block_rows=br,
                                                col_tile=ct) for a in ref])
    rng = np.random.default_rng(7)
    xp = _padded([rng.standard_normal(a.shape[0]) for a in port],
                 st.padded_rows)
    vals = values_tensor(st.vals, "cpu", sch.matrix_dtype)
    y = batch.batched_matvec_ellpack(
        torch.from_numpy(st.tile_cols), vals,
        torch.from_numpy(st.local_cols),
        torch.from_numpy(xp).to(sch.vector_dtype), col_tile=ct,
        n_col_tiles=st.n_col_tiles, scheme=sch).numpy()
    j = np.asarray(jax.jit(lambda tc, v, lc, x: ref_batch.batched_matvec_ellpack(
        tc, v, lc, x, col_tile=ct, n_col_tiles=rst.n_col_tiles, scheme=rsch,
        interpret=True))(
        jnp.asarray(rst.tile_cols),
        jnp.asarray(rst.vals).astype(rsch.matrix_dtype),
        jnp.asarray(rst.local_cols), jnp.asarray(xp, rsch.vector_dtype)))
    _scaled_close(y, j, _acc(scheme))

    m = csr_to_ellpack(port[0], block_rows=br, col_tile=ct)
    rm = ref_csr_to_ellpack(ref[0], block_rows=br, col_tile=ct)
    x1 = np.zeros(m.padded_cols)
    x1[: port[0].shape[0]] = xp[0, : port[0].shape[0]]
    y1 = K.spmv_ell(torch.from_numpy(m.tile_cols),
                    values_tensor(m.vals, "cpu", sch.matrix_dtype),
                    torch.from_numpy(m.local_cols),
                    torch.from_numpy(x1).reshape(-1, ct), scheme=sch)
    assert y1.dtype == sch.spmv_acc_dtype
    j1 = spmv_pallas(jnp.asarray(rm.tile_cols),
                     jnp.asarray(rm.vals).astype(rsch.matrix_dtype),
                     jnp.asarray(rm.local_cols),
                     jnp.asarray(x1).reshape(-1, ct), scheme=rsch,
                     interpret=True)
    _scaled_close(y1.float().numpy(), np.asarray(j1, np.float64),
                  _acc(scheme))


def test_tier_instantiation_codes():
    """tpu_fp32 takes mixed_v1's (f32, f32, f32) kernels; every tier
    scheme has an instantiation of its own dtypes, counted apart."""
    code = {s: K._scheme_code(get_scheme(s)) for s in
            ["mixed_v1", *TIER]}
    assert code["tpu_fp32"] == code["mixed_v1"]
    assert len({code[s] for s in TIER}) == 4
    for k in ("spmv_sell", "spmv_ellpack", "spmv_ell"):
        assert all(f"{k}[{s}]" in K.LAUNCHES for s in TIER)


# ---------------------------------------------------------------- solves
def _solve_bag(mod):
    return [mod.poisson_2d(10),
            mod.diag_dominant_spd(120, nnz_per_row=6, dominance=1.3, seed=5),
            mod.powerlaw_spd(200, alpha=2.1, seed=5)]


LAYOUTS = [("xla", "rowell"), ("xla", "sell"), ("pallas", "ellpack")]


def _assert_close(got, want, iters=1):
    for g, (a, b) in enumerate(zip(got, want)):
        assert a.status == b.status, f"lane {g}: {a.status} != {b.status}"
        assert abs(a.iterations - b.iterations) <= iters, (
            g, a.iterations, b.iterations)
        np.testing.assert_allclose(np.asarray(a.x, np.float64),
                                   np.asarray(b.x, np.float64),
                                   rtol=X_RTOL, atol=X_ATOL)


@pytest.mark.parametrize("backend,layout", LAYOUTS)
@pytest.mark.parametrize("scheme", ["tpu_fp32", "tpu_v3"])
def test_batched_solve_matches_jax_phases(scheme, backend, layout):
    kw = dict(tol=SOLVE_TOL, maxiter=500, scheme=scheme, backend=backend,
              layout=layout, **BK)
    ref_kw = dict(kw, interpret=True) if backend == "pallas" else kw
    ref = ref_solve(_solve_bag(ref_sparse), engine="phases", **ref_kw)
    got = jpcg_solve_batched(_solve_bag(port_sparse), device="cpu", **kw)
    assert all(r.status == "CONVERGED" for r in got)
    assert all(r.x.dtype == torch.float32 for r in got)
    _assert_close(got, ref)


@pytest.mark.parametrize("backend,layout", LAYOUTS)
@pytest.mark.parametrize("scheme", TIER)
def test_batched_vm_bitwise_equals_phases(scheme, backend, layout):
    """Inside the port the tier keeps the VM ≡ phases contract, the
    generic VM included."""
    kw = dict(tol=SOLVE_TOL, maxiter=500, scheme=scheme, backend=backend,
              layout=layout, device="cpu", **BK)
    bag = _solve_bag(port_sparse)
    vm = jpcg_solve_batched(bag, **kw)
    for other in (jpcg_solve_batched(bag, engine="phases", **kw),
                  jpcg_solve_batched(bag, specialize=False, **kw)):
        for a, b in zip(vm, other):
            assert (a.iterations, a.status) == (b.iterations, b.status)
            assert torch.equal(a.x, b.x)


def _spread(ref_runs) -> int:
    its = np.array([[r.iterations for r in run] for run in ref_runs])
    return int(np.abs(its[0] - its[1]).max())


def test_tpu_v1_batched_within_reference_spread():
    """bf16 accumulation: statuses equal; iterations within max(2, the
    reference's own xla-vs-pallas spread) of its phases engine."""
    kw = dict(tol=SOLVE_TOL, maxiter=500, scheme="tpu_v1", **BK)
    bag_r = _solve_bag(ref_sparse)
    ref_x = ref_solve(bag_r, engine="phases", backend="xla",
                      layout="rowell", **kw)
    ref_p = ref_solve(bag_r, engine="phases", backend="pallas",
                      layout="ellpack", interpret=True, **kw)
    bound = max(2, _spread([ref_x, ref_p]))
    for backend, layout, ref in (("xla", "rowell", ref_x),
                                 ("xla", "sell", ref_x),
                                 ("pallas", "ellpack", ref_p)):
        got = jpcg_solve_batched(_solve_bag(port_sparse), device="cpu",
                                 backend=backend, layout=layout, **kw)
        for g, (a, b) in enumerate(zip(got, ref)):
            assert a.status == b.status == "CONVERGED", (layout, g)
            assert abs(a.iterations - b.iterations) <= bound, (
                layout, g, a.iterations, b.iterations, bound)


SINGLE = {"poisson_2d(12)": lambda m: m.poisson_2d(12),
          "diag_dominant_spd(150)": lambda m: m.diag_dominant_spd(
              150, nnz_per_row=8, dominance=1.2, seed=7)}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("scheme", ["tpu_fp32", "tpu_v3"])
@pytest.mark.parametrize("name", list(SINGLE))
def test_single_system_matches_reference_pallas(name, scheme, backend):
    """Both port backends against the reference's ``pallas`` run (its
    ``xla`` run stops elsewhere at the tier)."""
    ref_op = ref_ell_operator(SINGLE[name](ref_sparse), scheme,
                              block_rows=128, col_tile=128, interpret=True)
    want = ref_jpcg_solve(ref_op, backend="pallas", scheme=scheme,
                          tol=SOLVE_TOL)
    ops.reset_launches()
    got = jpcg_solve(SINGLE[name](port_sparse), backend=backend,
                     scheme=scheme, tol=SOLVE_TOL, device="cpu", **BK)
    assert got.converged and want.converged
    assert abs(got.iterations - want.iterations) <= 1, (
        got.iterations, want.iterations)
    assert got.x.dtype == torch.float32
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=X_RTOL, atol=X_ATOL)
    assert set(ops.launches().values()) == {0}


@pytest.mark.parametrize("name", list(SINGLE))
def test_single_system_tpu_v1_within_reference_spread(name):
    kw = dict(scheme="tpu_v1", tol=SOLVE_TOL, block_rows=128, col_tile=128)
    a_r = SINGLE[name](ref_sparse)
    ref_x = ref_jpcg_solve(a_r, backend="xla", **kw)
    ref_p = ref_jpcg_solve(ref_ell_operator(a_r, "tpu_v1", block_rows=128,
                                            col_tile=128, interpret=True),
                           backend="pallas", scheme="tpu_v1", tol=SOLVE_TOL)
    bound = max(2, abs(ref_x.iterations - ref_p.iterations))
    for backend, ref in (("xla", ref_x), ("pallas", ref_p)):
        got = jpcg_solve(SINGLE[name](port_sparse), backend=backend,
                         device="cpu", **kw)
        assert got.converged == ref.converged
        assert abs(got.iterations - ref.iterations) <= bound, (
            backend, got.iterations, ref.iterations, bound)


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("scheme,backend,layout", [
    ("tpu_fp32", "xla", "auto"), ("tpu_v3", "xla", "sell"),
    ("tpu_v3", "pallas", "auto")])
def test_engine_matches_jax_at_tier(scheme, backend, layout):
    """Row-ELL, SELL (a bucket growth mid-run: in-place admission and
    compaction along the way) and ELLPACK pools at the tier."""
    kw = dict(batch_slots=8, chunk_iters=8, scheme=scheme, backend=backend,
              layout=layout, **BK)
    grow = layout == "sell"
    _, ref = _run(RefEngine, ref_sparse, RefConfig(**kw), grow_mid_run=grow)
    eng, got = _run(SolverEngine, port_sparse,
                    SolverEngineConfig(device="cpu", **kw),
                    grow_mid_run=grow)
    for g, (a, b) in enumerate(zip(got, ref)):
        assert a.status == b.status, f"request {g}"
        assert abs(a.iterations - b.iterations) <= 1, f"request {g}"
        np.testing.assert_allclose(np.asarray(a.x, np.float64),
                                   np.asarray(b.x, np.float64),
                                   rtol=X_RTOL, atol=X_ATOL)
    pool = eng._pool(None, None)
    assert pool.mat[1].dtype == get_scheme(scheme).matrix_dtype
    assert pool.state.mem.dtype == torch.float32
    assert got[2].status == "BREAKDOWN_INDEFINITE"


def test_engine_tier_compaction_is_bitwise_neutral():
    kw = dict(batch_slots=8, chunk_iters=4, scheme="tpu_v3", layout="sell",
              device="cpu", **BK)
    eng_c, packed = _run(SolverEngine, port_sparse,
                         SolverEngineConfig(compact_fraction=0.5, **kw))
    _, plain = _run(SolverEngine, port_sparse,
                    SolverEngineConfig(compact_fraction=0.0, **kw))
    assert eng_c.metrics()["compactions"] >= 1
    for a, b in zip(packed, plain):
        assert (a.iterations, a.status) == (b.iterations, b.status)
        assert torch.equal(a.x, b.x)


def test_engine_tier_escalates_to_fp64():
    """A matrix whose bf16 packing rounds singular breaks down in the
    tpu_v3 pool; the engine retries it once at fp64."""
    eps = 1e-4           # 1 - eps rounds to 1.0 in bf16
    a = np.array([[1.0, 1.0 - eps], [1.0 - eps, 1.0]])
    eng = SolverEngine(SolverEngineConfig(
        scheme="tpu_v3", batch_slots=4, chunk_iters=8, escalate_fp64=True,
        device="cpu"))
    rid = eng.submit(a, np.array([1.0, 0.0]), tol=1e-8, maxiter=50)
    res = eng.run_to_completion()[rid]
    assert res.retried and res.converged
    assert res.scheme == "fp64" and res.status == "CONVERGED"
    assert eng.metrics()["escalations"] == 1


def test_engine_tier_matches_batched_in_every_request():
    """The tier pool's lanes end where the batched solver ends: statuses
    and iterations equal, x within the fp32 tolerance (the warm-up's
    dot is its own per lane)."""
    reqs = _requests(port_sparse)
    eng = SolverEngine(SolverEngineConfig(
        batch_slots=8, chunk_iters=8, scheme="tpu_v3", layout="sell",
        device="cpu", **BK))
    rids = [eng.submit(a, b) for a, b in reqs]
    done = eng.run_to_completion()
    for (a, b), rid in zip(reqs, rids):
        want = jpcg_solve_batched([a], None if b is None else [b],
                                  scheme="tpu_v3", layout="sell",
                                  device="cpu", **BK)[0]
        got = done[rid]
        assert (got.status, got.iterations) == (want.status,
                                                want.iterations)
        np.testing.assert_allclose(got.x.numpy(), want.x.numpy(),
                                   rtol=X_RTOL, atol=X_ATOL)
