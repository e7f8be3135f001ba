"""The reference's public host functions in the port, against the JAX
package's originals on the CPU: the paper's §5.5 access accounting, the
golden ISA assembly and its disassembler, the compiled program's cache
token, the precision schemes' byte accounting, the Table 3 suite, the
bell and flat stackers, the stacked layouts' accounting, the ELLPACK
golden SpMV, the flat-stream matvec, the package exports, and Table 7's
small-tier iterations.

Exact where the port copies numpy code (words, bytes, strings, bits);
the flat-stream matvec within the reference's per-scheme ``_MV_RTOL``
(``tests/test_backend_diff.py``), since the two packages sum a row's
products in other orders; Table 7 within ±1 iteration.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

import repro.core as ref_core
import repro.sparse as ref_sparse
from repro.core import isa as ref_isa
from repro.core import vsr as ref_vsr
from repro.core.batch import batched_matvec_flat as ref_matvec_flat
from repro.core.cg import jpcg_solve as ref_jpcg_solve
from repro.core.compile import PLAIN_CG_MODULES as REF_PLAIN_CG
from repro.core.compile import compile_policy as ref_compile_policy
from repro.core.compile import compile_schedule as ref_compile_schedule
from repro.core.precision import SCHEMES as REF_SCHEMES
from repro.sparse import ellpack as ref_ellpack
from repro.sparse import generators as ref_generators
from repro.sparse import stacking as ref_stacking

import repro_torch.core as port_core
import repro_torch.sparse as port_sparse
from repro_torch.core import isa, vsr
from repro_torch.core.batch import batched_matvec_flat
from repro_torch.core.cg import jpcg_solve
from repro_torch.core.compile import (PLAIN_CG_MODULES, compile_policy,
                                      compile_schedule)
from repro_torch.core.precision import SCHEMES
from repro_torch.sparse import ellpack, generators, stacking

POLICIES = ["paper", "min_traffic"]
FAITHFUL = ["fp64", "mixed_v1", "mixed_v2", "mixed_v3"]
#: the reference's per-scheme SpMV tolerance (tests/test_backend_diff.py)
_MV_RTOL = {"fp64": 1e-13, "mixed_v1": 2e-5, "mixed_v2": 1e-7,
            "mixed_v3": 1e-7}
SMALL = ["tri_small", "struct_easy", "struct_hard", "struct_med",
         "poisson2d_64", "poisson2d_132", "powerlaw_skew"]
LARGE = ["poisson2d_500", "poisson2d_1000", "poisson3d_50",
         "poisson3d_100", "struct_large"]


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape and np.array_equal(a, b)


def _fields_equal(p, r):
    """Every field of two stacked dataclasses: arrays byte for byte,
    everything else equal."""
    names = [f.name for f in dataclasses.fields(r)]
    assert [f.name for f in dataclasses.fields(p)][:len(names)] == names
    for name in names:
        a, b = getattr(p, name), getattr(r, name)
        if isinstance(b, np.ndarray):
            _equal(a, b)
        else:
            assert a == b, name


# --------------------------------------------------------------- §5.5
def test_access_counts():
    assert vsr.access_counts() == ref_vsr.access_counts()
    assert vsr.access_counts() == {
        "naive": {"reads": 14, "writes": 5, "total": 19},
        "paper": {"reads": 10, "writes": 4, "total": 14},
        "min_traffic": {"reads": 9, "writes": 4, "total": 13}}


@pytest.mark.parametrize("policy", POLICIES)
def test_schedule_counts(policy):
    p, r = vsr.schedule(policy=policy), ref_vsr.schedule(policy=policy)
    assert (p.n_reads, p.n_writes, p.n_accesses) == \
        (r.n_reads, r.n_writes, r.n_accesses)
    assert (p.phases, p.hbm_reads, p.hbm_writes) == \
        (r.phases, r.hbm_reads, r.hbm_writes)


# ----------------------------------------------------------------- ISA
@pytest.mark.parametrize("policy", POLICIES)
def test_assemble_jpcg_word_for_word(policy):
    prog, instrs = isa.assemble_jpcg(policy)
    want, want_instrs = ref_isa.assemble_jpcg(policy)
    _equal(prog, want)
    assert [dataclasses.astuple(i) for i in instrs] == \
        [dataclasses.astuple(i) for i in want_instrs]
    assert isa.derived_mem_instructions(prog) == \
        ref_isa.derived_mem_instructions(want)
    assert [dataclasses.astuple(i) for i in isa.decode_program(prog)] == \
        [dataclasses.astuple(i) for i in ref_isa.decode_program(want)]
    assert isa.program_text(prog) == ref_isa.program_text(want)
    # the port's compiler reproduces the golden assembly word for word
    if policy == "paper":
        _equal(compile_policy("paper").program, prog)


@pytest.mark.parametrize("policy", POLICIES + ["plain_cg"])
def test_cache_token(policy):
    if policy == "plain_cg":
        got = compile_schedule(vsr.schedule(PLAIN_CG_MODULES,
                                            policy="min_traffic"),
                               PLAIN_CG_MODULES)
        want = ref_compile_schedule(
            ref_vsr.schedule(REF_PLAIN_CG, policy="min_traffic"),
            REF_PLAIN_CG)
    else:
        got, want = compile_policy(policy), ref_compile_policy(policy)
    assert got.cache_token == want.cache_token
    assert got.cache_token == isa.program_token(got.program)


# ----------------------------------------------------------- precision
@pytest.mark.parametrize("scheme", sorted(REF_SCHEMES))
def test_stream_bytes_per_scheme(scheme):
    p, r = SCHEMES[scheme], REF_SCHEMES[scheme]
    assert (p.matrix_bytes, p.vector_bytes) == (r.matrix_bytes,
                                                r.vector_bytes)
    for ib in (2, 4):
        assert p.nonzero_stream_bytes(index_bytes=ib) == \
            r.nonzero_stream_bytes(index_bytes=ib)
    assert p.nonzero_stream_bytes() == r.nonzero_stream_bytes()


@pytest.mark.parametrize("n", [1, 4096, 32767, 32768, 40000, 10 ** 6])
def test_index_bytes_for(n):
    assert stacking.index_bytes_for(n) == ref_stacking.index_bytes_for(n)


# ---------------------------------------------------------- the suite
@pytest.fixture(scope="module")
def small_suites():
    return (generators.benchmark_suite("small"),
            ref_generators.benchmark_suite("small"))


@pytest.mark.parametrize("name", SMALL)
def test_benchmark_suite_small_csr_bytes(small_suites, name):
    port, ref = small_suites
    assert list(port) == list(ref) == SMALL
    p, r = port[name], ref[name]
    assert p.shape == r.shape and p.nnz == r.nnz
    for f in ("indptr", "indices", "data"):
        _equal(getattr(p, f), getattr(r, f))
        assert getattr(p, f).tobytes() == getattr(r, f).tobytes()


@pytest.mark.parametrize("name", LARGE)
def test_benchmark_suite_large_metadata(name):
    """The large tier by its definition only (materialising n = 10^6
    matrices twice would dominate the run): the same factory, kwargs,
    seed and Table 3 analogue, and the tiers' membership."""
    pf, pkw, pa = generators._SUITE[name]
    rf, rkw, ra = ref_generators._SUITE[name]
    assert (pf.__name__, pkw, pa) == (rf.__name__, rkw, ra)
    assert generators.suite_metadata() == ref_generators.suite_metadata()
    assert sorted(generators._SUITE) == sorted(SMALL + LARGE)


# ---------------------------------------------------- bell and flat
def _bell_bag(mod):
    mats = [mod.poisson_2d(9), mod.tridiagonal_spd(70),
            mod.powerlaw_spd(150, alpha=2.1, seed=3)]
    return [mod.csr_to_bell(a, block_rows=8, col_tile=16) for a in mats]


@pytest.mark.parametrize("bucket", [True, False])
def test_bell_and_flat_stackers_byte_for_byte(bucket):
    port, ref = _bell_bag(port_sparse), _bell_bag(ref_sparse)
    _fields_equal(stacking.stack_bell(port, bucket=bucket),
                  ref_stacking.stack_bell(ref, bucket=bucket))
    sp = stacking.stack_flat(port, bucket=bucket)
    sr = ref_stacking.stack_flat(ref, bucket=bucket)
    _fields_equal(sp, sr)
    for prop in ("batch", "padded_rows", "padded_cols"):
        assert getattr(sp, prop) == getattr(sr, prop), prop
    sb, rb = (stacking.stack_bell(port, bucket=bucket),
              ref_stacking.stack_bell(ref, bucket=bucket))
    for prop in ("batch", "padded_rows", "padded_cols"):
        assert getattr(sb, prop) == getattr(rb, prop), prop
    for p, r in zip(port, ref):
        for a, b in zip(stacking.flatten_bell(p), ref_stacking.flatten_bell(r)):
            _equal(a, b)
        dims = dict(n_row_blocks=r.n_row_blocks + 3, n_slabs=r.n_slabs + 1,
                    slab_len=r.slab_len + 5)
        _fields_equal(stacking.pad_bell(p, **dims),
                      ref_stacking.pad_bell(r, **dims))


def _layout_bag(mod):
    return [mod.powerlaw_spd(160, alpha=2.1, seed=3), mod.poisson_2d(9),
            mod.diag_dominant_spd(90, nnz_per_row=6, dominance=1.2, seed=1)]


@pytest.mark.parametrize("scheme", FAITHFUL)
def test_stacked_layout_accounting(scheme):
    """``batch``, ``index_bytes``, ``padding_ratio``,
    ``stream_bytes_per_nnz``, ``total_slots`` and the padded dims of the
    three stacked layouts."""
    port, ref = _layout_bag(port_sparse), _layout_bag(ref_sparse)
    ps, rs = SCHEMES[scheme], REF_SCHEMES[scheme]
    pairs = [(stacking.stack_rowell(port, scheme=ps),
              ref_stacking.stack_rowell(ref, scheme=rs)),
             (stacking.stack_sell(port, scheme=ps),
              ref_stacking.stack_sell(ref, scheme=rs)),
             (stacking.stack_ellpack([port_sparse.csr_to_ellpack(
                 a, block_rows=8, col_tile=128) for a in port]),
              ref_stacking.stack_ellpack([ref_sparse.ellpack.csr_to_ellpack(
                  a, block_rows=8, col_tile=128) for a in ref]))]
    props = {"StackedRowEll": ("batch", "padded_rows", "width",
                               "padding_ratio", "index_bytes"),
             "StackedSell": ("batch", "padded_rows", "total_slots",
                             "padding_ratio", "index_bytes"),
             "StackedEllpack": ("batch", "padded_rows", "padded_cols")}
    for p, r in pairs:
        for prop in props[type(r).__name__]:
            assert getattr(p, prop) == getattr(r, prop), (type(r), prop)
        if hasattr(r, "stream_bytes_per_nnz"):
            assert p.stream_bytes_per_nnz() == r.stream_bytes_per_nnz()


# -------------------------------------------------------- ELLPACK, CSR
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ellpack_reference_and_accounting(dtype):
    a_p = port_sparse.powerlaw_spd(300, alpha=2.1, seed=5)
    a_r = ref_sparse.powerlaw_spd(300, alpha=2.1, seed=5)
    mp = ellpack.csr_to_ellpack(a_p, block_rows=8, col_tile=64).astype(dtype)
    mr = ref_ellpack.csr_to_ellpack(a_r, block_rows=8,
                                    col_tile=64).astype(dtype)
    _equal(mp.vals, mr.vals)
    assert (mp.stored_entries, mp.padding_efficiency, mp.stream_bytes(),
            mp.stream_bytes(value_bytes=2, index_bytes=4)) == \
        (mr.stored_entries, mr.padding_efficiency, mr.stream_bytes(),
         mr.stream_bytes(value_bytes=2, index_bytes=4))
    x = np.random.default_rng(6).standard_normal(300)
    _equal(ellpack.ellpack_spmv_reference(mp, x),
           ref_ellpack.ellpack_spmv_reference(mr, x))
    _equal(ellpack.ellpack_spmv_reference(mp, x, out_dtype=np.float32),
           ref_ellpack.ellpack_spmv_reference(mr, x, out_dtype=np.float32))


@pytest.mark.parametrize("n", [200, 5000])
def test_csr_astype_and_is_symmetric(n):
    """The dense check below 4,097 rows and the sampled one above."""
    a_p = port_sparse.diag_dominant_spd(n, nnz_per_row=6, seed=2)
    a_r = ref_sparse.diag_dominant_spd(n, nnz_per_row=6, seed=2)
    _equal(a_p.astype(np.float32).data, a_r.astype(np.float32).data)
    assert a_p.is_symmetric() == a_r.is_symmetric() is True
    bent = port_sparse.CSRMatrix(a_p.indptr, a_p.indices,
                                 a_p.data + np.arange(a_p.nnz) * 1e-3,
                                 a_p.shape)
    ref_bent = ref_sparse.CSRMatrix(a_r.indptr, a_r.indices,
                                    a_r.data + np.arange(a_r.nnz) * 1e-3,
                                    a_r.shape)
    assert bent.is_symmetric() == ref_bent.is_symmetric() is False
    assert bent.is_symmetric(tol=1e3) == ref_bent.is_symmetric(tol=1e3)


# ------------------------------------------------------ flat matvec
@pytest.mark.parametrize("scheme", FAITHFUL)
def test_batched_matvec_flat(scheme):
    port, ref = _bell_bag(port_sparse), _bell_bag(ref_sparse)
    sp, sr = stacking.stack_flat(port), ref_stacking.stack_flat(ref)
    x = np.random.default_rng(7).standard_normal((sp.batch, sp.padded_rows))
    got = batched_matvec_flat(
        torch.from_numpy(sp.gcols), torch.from_numpy(sp.vals),
        torch.from_numpy(sp.rows), torch.from_numpy(x),
        n_rows=sp.padded_rows, padded_cols=sp.padded_cols,
        scheme=SCHEMES[scheme])
    want = ref_matvec_flat(jnp.asarray(sr.gcols), jnp.asarray(sr.vals),
                           jnp.asarray(sr.rows), jnp.asarray(x),
                           n_rows=sr.padded_rows, padded_cols=sr.padded_cols,
                           scheme=REF_SCHEMES[scheme])
    assert got.dtype == SCHEMES[scheme].vector_dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=_MV_RTOL[scheme], atol=_MV_RTOL[scheme])


# ------------------------------------------------------------ exports
@pytest.mark.parametrize("pkg", ["core", "sparse"])
def test_package_exports(pkg):
    port = {"core": port_core, "sparse": port_sparse}[pkg]
    ref = {"core": ref_core, "sparse": ref_sparse}[pkg]
    assert set(ref.__all__) <= set(port.__all__)
    for name in port.__all__:
        obj = getattr(port, name)
        if callable(obj):
            assert obj.__module__.startswith("repro_torch."), name


# ------------------------------------------------------------ Table 7
@pytest.mark.parametrize("name", SMALL)
def test_table7_small_tier_iterations(small_suites, name):
    """The port's ``xla`` solve against the reference's ``jpcg_solve`` at
    the paper's protocol (b = 1, rr < 1e-12), fp64 and mixed_v3: the
    iterations within ±1, and so Table 7's ``diff_v3``."""
    port, ref = small_suites
    its = {}
    for scheme in ("fp64", "mixed_v3"):
        p = jpcg_solve(port[name], scheme=scheme, tol=1e-12, maxiter=20_000,
                       device="cpu")
        r = ref_jpcg_solve(ref[name], scheme=scheme, tol=1e-12,
                           maxiter=20_000)
        assert p.converged and r.converged
        assert abs(p.iterations - r.iterations) <= 1, (scheme, p.iterations,
                                                       r.iterations)
        its[scheme] = (p.iterations, r.iterations)
    diff = [its["mixed_v3"][i] - its["fp64"][i] for i in (0, 1)]
    assert abs(diff[0] - diff[1]) <= 2
