"""The stream VM's generic path in the port (the ISA program as an operand:
``specialize=False``, ``make_vm_runner/make_vm_stepper(program=None)``,
``vm_solve``) and MatrixMarket I/O.

Inside the port the generic path is held bitwise: generic ≡ specialized
≡ phases for the paper, min-traffic and plain-CG programs, with
``steps_per_sync`` 1 and 8, over row-ELL, SELL and ELLPACK.  Against the
JAX package it is held as the specialized path is: the reference's
phases engine at the solve tolerance (the same statuses, iterations
within ±1, x within ``rtol=1e-4, atol=1e-6``).  The serving engine's
state contracts of the reference's ``tests/test_batch.py`` are ported
with ``specialize`` both ways: a frozen lane's whole VM state is bit
stable, and a bucket growth carries every in-flight queue.
"""
import gzip
import shutil

import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

import repro.sparse as ref_sparse
from repro.core.batch import jpcg_solve_batched as ref_solve
from repro.core.compile import (PLAIN_CG_MODULES as REF_PLAIN_CG,
                                compile_policy as ref_compile_policy)
from repro.core.vm import vm_solve as ref_vm_solve
from repro.sparse.mtx import read_mtx as ref_read_mtx
from tests.oracles import assert_vm_states_equal

import repro_torch.sparse as port_sparse
from repro_torch.core import vm
from repro_torch.core.batch import (batch_cache_clear, batch_cache_info,
                                    jpcg_solve_batched)
from repro_torch.core.cg import jpcg_solve
from repro_torch.core.compile import (PLAIN_CG_MODULES, canonical_program,
                                      compile_policy)
from repro_torch.core.isa import BUF, ITYPE_VCTRL, SREG, pad_program
from repro_torch.core.vm import vm_executable_stats, vm_solve
from repro_torch.serve import SolverEngine, SolverEngineConfig
from repro_torch.sparse import read_mtx, write_mtx

BK = dict(block_rows=128, col_tile=128)
LAYOUTS = [("xla", "rowell"), ("xla", "sell"), ("pallas", "ellpack")]
TOL = 1e-12


def _bag(mod):
    return [mod.poisson_2d(10),
            mod.diag_dominant_spd(120, nnz_per_row=6, dominance=1.3, seed=5),
            mod.powerlaw_spd(200, alpha=2.1, seed=5)]


def _scaled(a, s):
    """``a / s`` with its structure: a unit diagonal for the stencils
    below (Poisson's diagonal is 4, the tridiagonal's 2: exact halvings)."""
    return type(a)(a.indptr, a.indices, a.data / s, a.shape)


def _unit_bag(mod):
    """Unit-diagonal systems: plain CG ≡ JPCG there, bit for bit."""
    return [_scaled(mod.poisson_2d(10), 4.0), _scaled(mod.poisson_2d(7), 4.0),
            _scaled(mod.tridiagonal_spd(150), 2.0)]


def _program(name):
    if name == "plain_cg":
        return compile_policy("min_traffic", PLAIN_CG_MODULES).program
    return canonical_program(name)


def _assert_bitwise(got, ref):
    for g, (a, b) in enumerate(zip(got, ref)):
        assert (a.iterations, a.status, a.rr) == (b.iterations, b.status,
                                                  b.rr), f"lane {g}"
        assert torch.equal(a.x, b.x), f"lane {g}: x differs"


@pytest.mark.parametrize("backend,layout", LAYOUTS)
@pytest.mark.parametrize("sps", [1, 8])
@pytest.mark.parametrize("program", ["paper", "min_traffic", "plain_cg"])
def test_generic_equals_specialized_and_phases(program, sps, backend,
                                               layout):
    prog = _program(program)
    bag = (_unit_bag if program == "plain_cg" else _bag)(port_sparse)
    kw = dict(tol=TOL, maxiter=500, backend=backend, layout=layout,
              steps_per_sync=sps, device="cpu", **BK)
    gen = jpcg_solve_batched(bag, program=prog, specialize=False, **kw)
    spec = jpcg_solve_batched(bag, program=prog, **kw)
    phases = jpcg_solve_batched(bag, engine="phases", **kw)
    assert all(r.status == "CONVERGED" for r in gen)
    assert all(r.method == "vm_batched[custom]|generic" for r in gen)
    _assert_bitwise(gen, spec)
    _assert_bitwise(gen, phases)


@pytest.mark.parametrize("backend,layout", LAYOUTS)
@pytest.mark.parametrize("policy", ["paper", "min_traffic"])
def test_generic_matches_jax_phases(policy, backend, layout):
    kw = dict(tol=TOL, maxiter=500, backend=backend, layout=layout, **BK)
    ref_kw = dict(kw, interpret=True) if backend == "pallas" else kw
    ref = ref_solve(_bag(ref_sparse), engine="phases", **ref_kw)
    got = jpcg_solve_batched(_bag(port_sparse), policy=policy,
                             specialize=False, device="cpu", **kw)
    assert [r.method for r in got] == [f"vm_batched[{policy}]|generic"] * 3
    for g, (a, b) in enumerate(zip(got, ref)):
        assert a.status == b.status, f"lane {g}"
        assert abs(a.iterations - b.iterations) <= 1, f"lane {g}"
        np.testing.assert_allclose(np.asarray(a.x), np.asarray(b.x),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("specialize", [True, False])
def test_vm_solve_plain_cg_on_unit_diag_system(specialize):
    """Plain CG ≡ JPCG when M = I (the reference's
    ``test_plain_cg_program_on_unit_diag_system``), and the reference's
    own ``vm_solve`` of the same program at the solve tolerance."""
    a = _scaled(port_sparse.poisson_2d(12), 4.0)
    prog = compile_policy("min_traffic", PLAIN_CG_MODULES).program
    assert np.array_equal(prog, ref_compile_policy(
        "min_traffic", REF_PLAIN_CG).program)
    out = vm_solve(a, program=prog, tol=TOL, maxiter=2000,
                   specialize=specialize, device="cpu", **BK)
    ph = jpcg_solve_batched([a], tol=TOL, maxiter=2000, engine="phases",
                            device="cpu", **BK)[0]
    assert out["iterations"] == ph.iterations and out["converged"]
    assert torch.equal(out["x"], ph.x)
    want = ref_vm_solve(_scaled(ref_sparse.poisson_2d(12), 4.0),
                        program=prog, tol=TOL, maxiter=2000,
                        specialize=specialize, **BK)
    assert abs(out["iterations"] - want["iterations"]) <= 1
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(want["x"]),
                               rtol=1e-4, atol=1e-6)
    single = jpcg_solve(a, tol=TOL, maxiter=2000, device="cpu", **BK)
    assert abs(single.iterations - out["iterations"]) <= 1


def test_one_runner_serves_every_program():
    """The generic runner is cached per bucket, never per program: two
    policies, plain CG and a NOP-padded copy run through one entry."""
    batch_cache_clear()
    bag = _unit_bag(port_sparse)
    kw = dict(tol=TOL, maxiter=500, specialize=False, device="cpu", **BK)
    first = jpcg_solve_batched(bag, policy="paper", **kw)
    info = batch_cache_info()
    assert info["entries"] == 1 and info["misses"] == 1
    assert vm_executable_stats() == {"executables": 1, "specialized": 0,
                                     "generic": 1}
    prog = canonical_program("paper")
    for other in (dict(policy="min_traffic"),
                  dict(program=pad_program(prog, prog.shape[0] + 5)),
                  dict(program=torch.from_numpy(prog)),
                  dict(program=_program("plain_cg"))):
        _assert_bitwise(jpcg_solve_batched(bag, **kw, **other), first)
    assert batch_cache_info()["entries"] == 1
    assert vm_executable_stats()["generic"] == 1
    jpcg_solve_batched(bag, tol=TOL, maxiter=500, device="cpu", **BK)
    assert vm_executable_stats() == {"executables": 2, "specialized": 1,
                                     "generic": 1}


def test_vctrl_word_reads_pre_instruction_state():
    """A VecCtrl word that both reads and writes (queue qa = qd) swaps a
    buffer and a queue as the reference's snapshot semantics say, on
    the generic executor and the specialized straight-line path alike."""
    g = np.random.default_rng(3)
    mem = torch.from_numpy(g.standard_normal((6, 2, 5)))
    queues = torch.from_numpy(g.standard_normal((8, 2, 5)))
    word = (ITYPE_VCTRL, BUF["r"], 1, 1, 4, 0, 4, 0)
    m, q = mem.clone(), queues.clone()
    vm._make_executor(None)(word, m, q, list(torch.zeros((6, 2)).unbind(0)))
    assert torch.equal(m[BUF["r"]], queues[4])
    assert torch.equal(q[4], mem[BUF["r"]])
    plan = vm._analyze_program(np.array([word], np.int32))
    n_mem, n_q, _ = vm._run_specialized(
        plan, None, {i: mem[i] for i in plan.carried_bufs},
        {j: queues[j] for j in plan.live_queues}, torch.zeros((6, 2)))
    assert torch.equal(n_mem[BUF["r"]], m[BUF["r"]])
    assert torch.equal(n_q[4], q[4])
    with pytest.raises(ValueError):
        vm._make_executor(None)((7,) + (0,) * 7, m, q, [])
    with pytest.raises(ValueError):
        vm._decode(np.zeros((3, 7), np.int32))


# ----------------------------------------------------------------- engine
def test_one_stepper_serves_two_policies():
    """``SolverEngineConfig(specialize=False)``: pools that differ only
    in policy share one cached generic stepper (the reference's
    ``test_per_request_policy_shares_executable``)."""
    eng = SolverEngine(SolverEngineConfig(batch_slots=2, chunk_iters=32,
                                          specialize=False, device="cpu",
                                          **BK))
    a = port_sparse.poisson_2d(16)
    r1 = eng.submit(a)
    eng.step()
    before = vm_executable_stats()
    r2 = eng.submit(a, policy="min_traffic")
    eng.run_to_completion()
    after = vm_executable_stats()
    assert after == before and after["generic"] >= 1
    g1, g2 = eng.results[r1], eng.results[r2]
    assert g1.method == "vm_engine[paper]"
    assert g2.method == "vm_engine[min_traffic]"
    assert g1.iterations == g2.iterations and torch.equal(g1.x, g2.x)
    spec = SolverEngine(SolverEngineConfig(batch_slots=2, chunk_iters=32,
                                           device="cpu", **BK))
    rs = spec.submit(a)
    spec.run_to_completion()
    assert spec.results[rs].iterations == g1.iterations
    assert torch.equal(spec.results[rs].x, g1.x)


@pytest.mark.parametrize("specialize", [True, False])
def test_bucket_growth_preserves_inflight_queues(specialize):
    """Growing the bucket mid-flight copies the queue file like ``mem``.
    The generic stepper runs queue ops against the full state, so live
    streams are nonzero and survive growth; the specialized stepper
    leaves the canonical programs' phase-local queues untouched (zero)."""
    eng = SolverEngine(SolverEngineConfig(
        batch_slots=2, chunk_iters=8, specialize=specialize, device="cpu",
        **BK))
    hard = port_sparse.tridiagonal_spd(300)
    r1 = eng.submit(hard)
    eng.step()                               # 8 iterations: queues live
    pool = eng._pool(None, None)
    assert bool(pool.state.active[0])
    q_before = pool.state.queues.clone().numpy()
    if specialize:
        assert np.all(q_before == 0.0)
    else:
        assert np.any(q_before != 0.0)
    m_before = pool.state.mem.clone().numpy()
    big = port_sparse.poisson_2d(40)
    r2 = eng.submit(big)                     # larger problem: bucket grows
    old_n = q_before.shape[-1]
    q_after = eng._pool(None, None).state.queues.numpy()
    assert q_after.shape[-1] > old_n
    assert np.array_equal(q_after[:, 0, :old_n], q_before[:, 0])
    assert np.all(q_after[:, 0, old_n:] == 0.0)
    assert np.array_equal(
        eng._pool(None, None).state.mem.numpy()[:, 0, :old_n],
        m_before[:, 0])
    eng.run_to_completion()
    for rid, a in ((r1, hard), (r2, big)):
        ref = jpcg_solve(a, tol=TOL, maxiter=20_000, device="cpu", **BK)
        got = eng.results[rid]
        assert got.converged
        assert abs(got.iterations - ref.iterations) <= 1
        np.testing.assert_allclose(got.x.numpy(), ref.x.numpy(),
                                   rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("specialize", [True, False])
def test_frozen_slot_state_is_bit_stable(specialize):
    """Once a slot converges its whole VM state — mem, queues, sregs, it
    — stays bit stable while the other slot iterates (``chunk_iters=1``
    pins the check to the tick right after convergence)."""
    eng = SolverEngine(SolverEngineConfig(
        batch_slots=2, chunk_iters=1, specialize=specialize, device="cpu",
        **BK))
    eng.submit(port_sparse.tridiagonal_spd(128, off=-0.1))  # freezes first
    eng.submit(port_sparse.tridiagonal_spd(256))            # keeps going
    pool = eng._pool(None, None)
    while bool(pool.state.active[0]) and bool(pool.state.active[1]):
        eng.step()
    frozen = 0 if not bool(pool.state.active[0]) else 1
    assert bool(pool.state.active[1 - frozen])
    snap = {f: getattr(pool.state, f).clone().numpy()
            for f in ("mem", "queues", "sregs", "it")}
    if not specialize:
        assert np.any(snap["queues"][:, frozen] != 0.0)
    eng.step()
    assert bool(pool.state.active[1 - frozen])
    assert_vm_states_equal(pool.state, snap, lane=frozen)
    assert float(pool.state.sregs[SREG["rr"], frozen]) == float(
        snap["sregs"][SREG["rr"], frozen])


@pytest.mark.parametrize("backend,layout", [("xla", "sell"),
                                            ("pallas", "auto")])
def test_generic_engine_equals_specialized_engine(backend, layout):
    """Serving through the generic stepper changes dispatch, never
    arithmetic: every request ends where the specialized engine's does,
    bit for bit (bucket growth and compaction included)."""
    from tests.test_torch_solver_engine import _run
    out = {}
    for specialize in (True, False):
        cfg = SolverEngineConfig(batch_slots=8, chunk_iters=4,
                                 backend=backend, layout=layout,
                                 specialize=specialize, device="cpu", **BK)
        eng, out[specialize] = _run(SolverEngine, port_sparse, cfg)
        assert eng.metrics()["compactions"] >= 1
    for a, b in zip(out[True], out[False]):
        assert (a.iterations, a.status) == (b.iterations, b.status)
        assert torch.equal(a.x, b.x)


# ---------------------------------------------------------- MatrixMarket
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("compressed", [False, True])
def test_mtx_round_trip(tmp_path, symmetric, compressed):
    """``write_mtx`` then ``read_mtx`` (plain, and gzip-compressed for
    reading) gives the matrix back; the reference reads the same file to
    the same CSR."""
    a = port_sparse.diag_dominant_spd(60, nnz_per_row=5, dominance=1.3,
                                      seed=2)
    path = tmp_path / "a.mtx"
    write_mtx(path, a, symmetric=symmetric)
    if compressed:
        gz = tmp_path / "a.mtx.gz"
        with open(path, "rb") as src, gzip.open(gz, "wb") as dst:
            shutil.copyfileobj(src, dst)
        path = gz
    got = read_mtx(path)
    assert got.shape == a.shape
    assert np.array_equal(got.indptr, a.indptr)
    assert np.array_equal(got.indices, a.indices)
    assert np.array_equal(got.data, a.data)
    ref = ref_read_mtx(path)
    assert np.array_equal(ref.indptr, got.indptr)
    assert np.array_equal(ref.indices, got.indices)
    assert np.array_equal(ref.data, got.data)


def test_mtx_rejects_other_formats(tmp_path):
    path = tmp_path / "b.mtx"
    path.write_text("%%MatrixMarket matrix array real general\n2 2\n1\n0\n"
                    "0\n1\n")
    with pytest.raises(ValueError):
        read_mtx(path)
    path.write_text("not a matrix\n")
    with pytest.raises(ValueError):
        read_mtx(path)


# ------------------------------------------------------------- block_rows
@pytest.mark.parametrize("specialize", [True, False])
def test_vm_runner_and_stepper_take_block_rows(specialize):
    """``make_vm_runner`` / ``make_vm_stepper(block_rows=)``, which the
    reference takes: a value equal to the packed ELLPACK operand's tile
    rows runs bit for bit as without it; another raises ``ValueError``
    with the reason."""
    from repro_torch.core.batch import (_matvec_factory, _pad_stack,
                                        stack_operands)
    from repro_torch.core.precision import get_scheme
    from repro_torch.core.vm import make_vm_runner, make_vm_stepper, vm_init
    sch = get_scheme("mixed_v3")
    csrs = [port_sparse.poisson_2d(12), port_sparse.tridiagonal_spd(100)]
    mat, stacked, _, n_ct, dims = stack_operands(
        csrs, backend="pallas", layout="ellpack", scheme=sch, device="cpu",
        **BK)
    n_pad, vd, G = stacked.padded_rows, sch.vector_dtype, len(csrs)
    diag = _pad_stack([a.diagonal() for a in csrs], n_pad, 1.0, vd, "cpu")
    b = _pad_stack([np.ones(a.shape[0]) for a in csrs], n_pad, 0.0, vd,
                   "cpu")
    x0 = torch.zeros((G, n_pad), dtype=vd)
    tol = torch.full((G,), TOL, dtype=vd)
    prog = canonical_program("paper")
    head = () if specialize else (prog,)
    kw = dict(backend="pallas", scheme=sch, layout="ellpack",
              col_tile=BK["col_tile"], n_col_tiles=n_ct,
              program=prog if specialize else None)

    def solve(**extra):
        run = make_vm_runner(maxiter=500, with_trace=False, **kw, **extra)
        return run(*head, mat, diag, b, x0, tol)

    want = solve()
    assert_vm_states_equal(solve(block_rows=BK["block_rows"]), want)
    with pytest.raises(ValueError, match="tile rows"):
        solve(block_rows=2 * BK["block_rows"])

    def step(**extra):
        mv = _matvec_factory(backend="pallas", scheme=sch, layout="ellpack",
                             col_tile=BK["col_tile"], n_col_tiles=n_ct)(mat)
        st = vm_init(mv, diag, b, x0, maxiter=500, with_trace=False,
                     tol=tol)
        stepper = make_vm_stepper(bucket=dims, chunk=16, **kw, **extra)
        return stepper(*head, mat, st, tol,
                       torch.full((G,), 500, dtype=torch.int32))

    assert_vm_states_equal(step(block_rows=BK["block_rows"]), step())
    with pytest.raises(ValueError, match="tile rows"):
        step(block_rows=2 * BK["block_rows"])
