"""Lane sharding in the port (``mesh=``), against its own unsharded path.

The port's mesh is a tuple of devices; on the CPU ``("cpu",) * D`` runs D
lane shards in one process.  Every observable of a sharded solve — x, rr,
iterations, statuses and trace — equals the unsharded one bit for bit for
every scheme × layout × engine × ``steps_per_sync``, on a bag whose lanes
converge, exhaust ``maxiter`` and break down mid-chunk on different
shards (``tests/test_shard.py``'s bag).  The reference's own 8-device
tests do not pass on this tree's JAX, so the unsharded port is the
oracle; one cross-check holds the port's sharded solve against the
reference's on its 1-device mesh, at the solve tolerance.
"""
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

import repro.sparse as ref_sparse
from repro.core.batch import jpcg_solve_batched as ref_solve_batched
from repro.core.shard import lane_mesh as ref_lane_mesh
from repro.sparse.stacking import lane_bucket_up as ref_lane_bucket_up

import repro_torch.sparse as port_sparse
from repro_torch.core import shard
from repro_torch.core.batch import (_matvec_factory, _pad_stack, _row_dot,
                                    batch_cache_clear,
                                    batch_cache_info, jpcg_solve_batched,
                                    stack_operands)
from repro_torch.core.compile import canonical_program, executable_key
from repro_torch.core.metrics import reset_solver_metrics, solver_metrics
from repro_torch.core.precision import get_scheme
from repro_torch.core.vm import make_vm_runner, make_vm_stepper, vm_init
from repro_torch.serve import SolverEngine, SolverEngineConfig
from repro_torch.sparse.stacking import lane_bucket_up
from tests.oracles import assert_results_bit_identical, assert_statuses

BK = dict(block_rows=8, col_tile=128)
SCHEMES = ("fp64", "mixed_v1", "mixed_v2", "mixed_v3")
#: (backend, layout): row-ELL and SELL on xla, ELLPACK on pallas
LAYOUTS = (("xla", "rowell"), ("xla", "sell"), ("pallas", "ellpack"))
MESHES = (1, 2, 4)
#: not a multiple of steps_per_sync=8: budget exits land mid-chunk
MAXITER = 11
EXPECTED = {1: "MAXITER", 2: "BREAKDOWN_INDEFINITE",
            4: "BREAKDOWN_NONFINITE"}


def cpu_mesh(d):
    return shard.lane_mesh(("cpu",) * d)


def _singular_j(mod, n):
    i = np.repeat(np.arange(n), n)
    j = np.tile(np.arange(n), n)
    b = np.zeros(n)
    b[0], b[1] = 1.0, -1.0
    return mod.csr_from_coo(i, j, np.ones(n * n), (n, n)), b


def _mixed_fate_bag(mod, n, seed):
    """5 lanes whose fates diverge mid-chunk, on different shards: converge
    fast, exhaust maxiter, break down indefinite, run long, break down
    non-finite."""
    sing_a, sing_b = _singular_j(mod, n)
    nan_b = np.ones(n)
    nan_b[0] = np.nan
    probs = [mod.tridiagonal_spd(n, off=-0.1),
             mod.random_spd(n, cond=1e6, seed=seed + 1), sing_a,
             mod.random_spd(n, cond=50.0, seed=seed),
             mod.tridiagonal_spd(n)]
    bs = [np.ones(n), np.ones(n), sing_b, np.ones(n), nan_b]
    return probs, bs, [1e-10, 1e-30, 1e-10, 1e-10, 1e-10]


def _results(res):
    """Results with x on the host, for the bitwise oracle."""
    for r in res:
        r.x = r.x.cpu().numpy()
    return res


def _solve(probs, bs, **kw):
    return _results(jpcg_solve_batched(probs, bs, **kw))


# ------------------------------------------------------- bit identity
@pytest.mark.parametrize("sps", [1, 8])
@pytest.mark.parametrize("engine", ["vm", "phases"])
@pytest.mark.parametrize("backend,layout", LAYOUTS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_sharded_equals_unsharded(scheme, backend, layout, engine, sps):
    probs, bs, tols = _mixed_fate_bag(port_sparse, 16, seed=3)
    kw = dict(tol=tols, maxiter=MAXITER, scheme=scheme, backend=backend,
              layout=layout, engine=engine, steps_per_sync=sps,
              with_trace=True, **BK)
    ref = _solve(probs, bs, device="cpu", **kw)
    assert_statuses(ref, EXPECTED, healthy=(0,), maxiter=100)
    for d in MESHES:
        got = _solve(probs, bs, mesh=cpu_mesh(d), **kw)
        assert_results_bit_identical(got, ref, rr=True, trace=True,
                                     status=True)


@pytest.mark.parametrize("policy", ["paper", "min_traffic"])
@pytest.mark.parametrize("layout", ["rowell", "sell"])
def test_generic_vm_path_sharded(layout, policy):
    """The program-as-operand VM (``specialize=False``) shards too."""
    probs, bs, tols = _mixed_fate_bag(port_sparse, 24, seed=4)
    kw = dict(tol=tols, maxiter=MAXITER, specialize=False, layout=layout,
              policy=policy, with_trace=True, **BK)
    ref = _solve(probs, bs, device="cpu", **kw)
    for d in MESHES:
        got = _solve(probs, bs, mesh=cpu_mesh(d), **kw)
        assert_results_bit_identical(got, ref, rr=True, trace=True,
                                     status=True)


@pytest.mark.parametrize("layout", ["rowell", "sell"])
def test_tier_scheme_sharded(layout):
    """One TPU-tier scheme (bf16 values, fp32 vectors) through the mesh."""
    probs = [port_sparse.poisson_2d(5), port_sparse.tridiagonal_spd(20),
             port_sparse.powerlaw_spd(40, alpha=2.1, seed=2)]
    kw = dict(tol=1e-8, maxiter=60, scheme="tpu_v3", layout=layout, **BK)
    ref = _solve(probs, None, device="cpu", **kw)
    for d in MESHES:
        assert_results_bit_identical(
            _solve(probs, None, mesh=cpu_mesh(d), **kw), ref, rr=True,
            status=True)


@pytest.mark.parametrize("d", [2, 4])
def test_lane_padding_is_invisible(d):
    """G = 5 over D ∈ {2, 4} pads with inert identity lanes: the results
    and the solver metrics see only the five real lanes."""
    probs, bs, tols = _mixed_fate_bag(port_sparse, 16, seed=1)
    mesh = cpu_mesh(d)
    assert shard.pad_lanes(len(probs), mesh) % d == 0
    assert shard.pad_lanes(len(probs), mesh) > len(probs)
    ref = _solve(probs, bs, tol=tols, maxiter=MAXITER, device="cpu", **BK)
    reset_solver_metrics()
    try:
        res = _solve(probs, bs, tol=tols, maxiter=MAXITER, mesh=mesh, **BK)
        m = solver_metrics().snapshot()
    finally:
        reset_solver_metrics()
    assert len(res) == len(probs)
    assert m["lanes"] == len(probs)
    assert sum(m["exit_status"].values()) == len(probs)
    assert m["iterations"] == sum(r.iterations for r in ref)
    assert_results_bit_identical(res, ref, rr=True, status=True)


# ------------------------------------------------- runners and steppers
def _operands(probs, bs, tols, layout, scheme="mixed_v3"):
    sch = get_scheme(scheme)
    backend = "pallas" if layout == "ellpack" else "xla"
    mat, stacked, groups, n_ct, dims = stack_operands(
        probs, backend=backend, layout=layout, scheme=sch, device="cpu",
        **BK)
    n_pad, vd = stacked.padded_rows, sch.vector_dtype
    args = (mat, _pad_stack([a.diagonal() for a in probs], n_pad, 1.0, vd,
                            "cpu"),
            _pad_stack(bs, n_pad, 0.0, vd, "cpu"),
            torch.zeros((len(probs), n_pad), dtype=vd),
            torch.tensor(tols, dtype=vd))
    kw = dict(backend=backend, scheme=sch, layout=layout, groups=groups,
              col_tile=BK["col_tile"], n_col_tiles=n_ct)
    return args, kw, dims


def _lane_cat(states, name, axis=0):
    return torch.cat([getattr(s, name) for s in states], dim=axis)


def _assert_state_equal(sharded, whole):
    for name, axis in (("it", 0), ("status", 0), ("mem", 1), ("queues", 1),
                       ("sregs", 1), ("active", 0), ("trace", 0)):
        got, want = _lane_cat(sharded, name, axis), getattr(whole, name)
        if got.is_floating_point():       # NaN lanes: equal where NaN too
            assert torch.equal(got.isnan(), want.isnan()), name
            got, want = got.nan_to_num(7.0), want.nan_to_num(7.0)
        assert torch.equal(got, want), name
    for s in sharded:                     # k is replicated
        assert torch.equal(s.k, whole.k)


@pytest.mark.parametrize("specialize", [True, False])
@pytest.mark.parametrize("layout", ["rowell", "sell", "ellpack"])
def test_vm_runner_and_stepper_sharded(layout, specialize):
    """``make_vm_runner`` / ``make_vm_stepper(mesh=)`` on operands laid out
    by ``place_lanes`` / ``place_vm_state``: every state tensor of every
    shard is the unsharded state's lanes, ``k`` replicated."""
    probs, bs, tols = _mixed_fate_bag(port_sparse, 16, seed=2)
    probs, bs, tols = probs[:4], bs[:4], tols[:4]
    args, kw, dims = _operands(probs, bs, tols, layout)
    prog = canonical_program("paper")
    rkw = dict(kw, maxiter=MAXITER, with_trace=True, steps_per_sync=8)
    for d in MESHES:
        mesh = cpu_mesh(d)
        placed = tuple(shard.place_lanes(mesh, a) for a in args)
        if specialize:
            whole = make_vm_runner(program=prog, **rkw)(*args)
            parts = make_vm_runner(program=prog, mesh=mesh, **rkw)(*placed)
        else:
            whole = make_vm_runner(**rkw)(prog, *args)
            parts = make_vm_runner(mesh=mesh, **rkw)(prog, *placed)
        assert isinstance(parts, shard.Shards) and len(parts) == d
        _assert_state_equal(parts, whole)

        # the serving stepper: two bounded chunks from the warm-up state
        init = vm_init(_matvec_factory(**kw)(args[0]), *args[1:4],
                       maxiter=0, with_trace=False, tol=args[4])
        skw = dict(kw, bucket=dims, chunk=5, steps_per_sync=2, detect=True)
        budget = torch.full((len(probs),), 7, dtype=torch.int32)
        step = make_vm_stepper(program=prog if specialize else None, **skw)
        step_d = make_vm_stepper(program=prog if specialize else None,
                                 mesh=mesh, **skw)
        head = () if specialize else (prog,)
        st, st_d = init, shard.place_vm_state(mesh, init)
        for _ in range(2):
            st = step(*head, args[0], st, args[4], budget)
            st_d = step_d(*head, placed[0], st_d, placed[4],
                          shard.place_lanes(mesh, budget))
        _assert_state_equal(st_d, st)


def test_sharded_runner_takes_placed_operands():
    probs, bs, tols = _mixed_fate_bag(port_sparse, 16, seed=2)
    args, kw, _ = _operands(probs[:2], bs[:2], tols[:2], "rowell")
    run = make_vm_runner(program=canonical_program("paper"),
                         mesh=cpu_mesh(2), maxiter=5, with_trace=False, **kw)
    with pytest.raises(TypeError, match="place_lanes"):
        run(*args)


# ------------------------------------------------------------- engine
def _drive(mesh, backend="xla", layout="auto", **cfg):
    where = dict(device="cpu") if mesh is None else dict(mesh=mesh)
    eng = SolverEngine(SolverEngineConfig(
        batch_slots=8, chunk_iters=8, backend=backend, layout=layout,
        **where, **cfg, **BK))
    probs, bs, tols = _mixed_fate_bag(port_sparse, 16, seed=5)
    rids = [eng.submit(a, b, tol=t, maxiter=MAXITER)
            for a, b, t in zip(probs, bs, tols)]
    eng.run_to_completion()
    return _results([eng.results[r] for r in rids]), eng.metrics()


@pytest.mark.parametrize("d", MESHES)
@pytest.mark.parametrize("backend,layout", [("xla", "auto"),
                                            ("xla", "sell"),
                                            ("pallas", "auto")])
def test_sharded_engine_matches_unsharded(backend, layout, d):
    """A sharded SolverEngine serving mixed-fate requests harvests the same
    results bit for bit, the same exit histogram, admits and harvests."""
    ref, m_ref = _drive(None, backend, layout)
    got, m_got = _drive(cpu_mesh(d), backend, layout)
    assert_results_bit_identical(got, ref, rr=True, status=True)
    assert m_got["exit_status"] == m_ref["exit_status"]
    assert m_got["admits"] == m_ref["admits"] == 5
    assert m_got["harvests"] == m_ref["harvests"] == 5
    assert m_got["iterations"] == m_ref["iterations"]
    assert [p["shards"] for p in m_got["pools"].values()] == [d]


@pytest.mark.parametrize("layout", ["rowell", "sell"])
def test_compaction_keeps_lanes_on_their_shard(layout):
    """Over admissions, harvests, compactions and regrowth, a live request
    never changes shard, every shard keeps the same lane count, and the
    results equal the unsharded engine's bit for bit."""
    d = 2

    def run(mesh):
        where = dict(device="cpu") if mesh is None else dict(mesh=mesh)
        eng = SolverEngine(SolverEngineConfig(
            batch_slots=8, chunk_iters=4, compact_fraction=0.75,
            layout=layout, **where, **BK))
        rng = np.random.default_rng(11)
        home, rids, compactions = {}, [], 0
        for tick in range(40):
            if tick < 24 and rng.random() < 0.6 and eng.free_slots() > 0:
                n = int(rng.choice([16, 24]))
                a = (port_sparse.random_spd(n, cond=100.0, seed=tick)
                     if rng.random() < 0.5 else
                     port_sparse.tridiagonal_spd(n, off=-0.1))
                rids.append(eng.submit(a, tol=1e-10, maxiter=int(
                    rng.integers(5, 60))))
            eng.step()
            for pool in eng._pools.values():
                per = pool.slots // pool.n_dev
                for s, rid in enumerate(pool.req_of_slot):
                    if rid is not None and mesh is not None:
                        assert home.setdefault(rid, s // per) == s // per
                assert pool.slots % pool.n_dev == 0
                assert all(st.it.shape[0] == per for st in pool.states)
        eng.run_to_completion()
        compactions = eng.metrics().get("compactions", 0)
        return _results([eng.results[r] for r in rids]), compactions

    ref, _ = run(None)
    got, compactions = run(cpu_mesh(d))
    assert compactions > 0
    assert_results_bit_identical(got, ref, rr=True, status=True)


class TestShardedSoak:
    """A seeded randomized soak against a 2-shard engine: admissions,
    steps, harvests, compactions and bucket growth interleave; every
    request terminates classified and the metrics balance."""

    KINDS = ("easy", "hard", "budget", "singular", "nonfinite")
    WANT = {"easy": "CONVERGED", "hard": "CONVERGED",
            "budget": "MAXITER", "singular": "BREAKDOWN_INDEFINITE",
            "nonfinite": "BREAKDOWN_NONFINITE"}

    def _submit(self, eng, rng, k):
        kind = self.KINDS[int(rng.integers(0, len(self.KINDS)))]
        n = int(rng.choice([16, 24]))
        if kind == "easy":
            a, b, tol, mi = port_sparse.tridiagonal_spd(n, off=-0.1), None, \
                1e-10, 500
        elif kind == "hard":
            a, b, tol, mi = port_sparse.random_spd(n, cond=100.0, seed=k), \
                None, 1e-10, 500
        elif kind == "budget":
            a, b, tol, mi = port_sparse.tridiagonal_spd(n), None, 1e-30, 3
        elif kind == "singular":
            (a, b), tol, mi = _singular_j(port_sparse, n), 1e-10, 500
        else:
            a, b, tol, mi = port_sparse.tridiagonal_spd(n), np.ones(n), \
                1e-10, 500
            b[0] = np.nan
        return eng.submit(a, b, tol=tol, maxiter=mi), kind

    def test_soak_60_ticks(self):
        rng = np.random.default_rng(20260808)
        eng = SolverEngine(SolverEngineConfig(
            batch_slots=8, chunk_iters=4, compact_fraction=0.75,
            mesh=cpu_mesh(2), **BK))
        kinds = {}
        for tick in range(60):
            if rng.random() < 0.4 and eng.free_slots() > 0:
                rid, kind = self._submit(eng, rng, tick)
                kinds[rid] = kind
            eng.step()
        eng.run_to_completion()
        assert kinds and set(eng.results) == set(kinds)
        hist = {}
        for rid, kind in kinds.items():
            want = self.WANT[kind]
            assert eng.results[rid].status == want, (kind,
                                                     eng.results[rid].status)
            hist[want] = hist.get(want, 0) + 1
        m = eng.metrics()
        assert m["admits"] == m["harvests"] == len(kinds)
        assert m["exit_status"] == hist
        for p in m["pools"].values():
            assert p["occupied"] == 0 and p["active"] == 0
            assert p["shards"] == 2


# ----------------------------------------------------------- plumbing
def test_mesh_signature_splits_executable_key():
    """Unsharded and every mesh size give distinct keys — a 1-shard mesh
    is not the unsharded runner — and the devices do not enter them."""
    base = dict(backend="xla", scheme="mixed_v3", bucket=(256, 8),
                layout="rowell", index_bytes=2, steps_per_sync=8,
                donate=False)
    meshes = [None, cpu_mesh(1), cpu_mesh(2), cpu_mesh(4)]
    keys = {executable_key("vm_step", mesh=m, **base) for m in meshes}
    assert len(keys) == len(meshes)
    assert shard.mesh_signature(None) is None
    assert shard.mesh_signature(cpu_mesh(2)) == (("lanes", 2),)
    assert shard.mesh_signature((("lanes", 2),)) == (("lanes", 2),)
    assert executable_key("vm_step", mesh=cpu_mesh(2), **base) == \
        executable_key("vm_step", mesh=(("lanes", 2),), **base)
    assert [shard.mesh_shards(m) for m in meshes] == [1, 1, 2, 4]


def test_runner_cache_one_entry_per_mesh_size():
    """Mesh sizes 1, 2, 4 are three runners, none the unsharded one; a
    repeat is a hit."""
    probs = [port_sparse.tridiagonal_spd(16 + 2 * g) for g in range(4)]
    batch_cache_clear()
    seq = []
    for mesh in (None, cpu_mesh(1), cpu_mesh(2), cpu_mesh(4)):
        for _ in range(2):
            where = dict(device="cpu") if mesh is None else dict(mesh=mesh)
            jpcg_solve_batched(probs, tol=1e-10, maxiter=20, **where, **BK)
        seq.append(batch_cache_info())
    batch_cache_clear()
    assert [s["entries"] for s in seq] == [1, 2, 3, 4]
    assert [s["misses"] for s in seq] == [1, 2, 3, 4]
    assert [s["hits"] for s in seq] == [1, 2, 3, 4]


def test_place_lanes_and_vm_state():
    mesh = cpu_mesh(2)
    t = torch.arange(24.0).reshape(4, 6)
    parts = shard.place_lanes(mesh, t)
    assert isinstance(parts, shard.Shards)
    assert [p.tolist() for p in parts] == [t[:2].tolist(), t[2:].tolist()]
    assert shard.place_lanes(mesh, parts) is parts
    assert shard.place_lanes(None, t) is t
    pair = shard.place_lanes(mesh, (t, t[:, :2]))
    assert [tuple(a.shape) for a in pair[1]] == [(2, 6), (2, 2)]
    with pytest.raises(ValueError, match="equal shards"):
        shard.place_lanes(cpu_mesh(4), torch.zeros(6))
    args, kw, _ = _operands(*(x[:4] for x in _mixed_fate_bag(
        port_sparse, 16, seed=2)), layout="sell")
    st = make_vm_runner(program=canonical_program("paper"), maxiter=0,
                        with_trace=False, **kw)(*args)
    st_d = shard.place_vm_state(mesh, st)
    _assert_state_equal(st_d, st)
    st_d[0].mem.add_(1.0)                  # pieces are copies
    assert not torch.equal(st_d[0].mem, st.mem[:, :2])
    # a SELL operand's table is rebuilt per shard from its lanes' widths
    table, t_parts = args[0][3], [m[3] for m in
                                  shard.place_lanes(mesh, args[0])]
    for i, tp in enumerate(t_parts):
        assert torch.equal(tp.lane_widths,
                           table.lane_widths[2 * i:2 * i + 2])


def test_lane_mesh_default_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shard.lane_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SolverEngine(SolverEngineConfig(mesh=("cuda", "cuda")))
    assert shard.lane_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 8])
def test_lane_bucket_up_matches_reference(parts):
    for x in range(1, 70):
        assert lane_bucket_up(x, parts=parts) == \
            ref_lane_bucket_up(x, parts=parts)


def test_row_dot_bits_do_not_depend_on_lane_count():
    """Each row's dot has the same bits whatever rows share the call (the
    property that makes lane shards and compaction bitwise neutral)."""
    rng = np.random.default_rng(0)
    for n in (5, 16, 33, 1000, 4096, 131072, 140003):
        a = torch.from_numpy(rng.standard_normal((8, n)))
        b = torch.from_numpy(rng.standard_normal((8, n)))
        whole = _row_dot(a, b)
        for g0, g1 in ((0, 1), (3, 4), (2, 6), (0, 8)):
            assert torch.equal(_row_dot(a[g0:g1], b[g0:g1]), whole[g0:g1])


# ------------------------------------------------- against the reference
@pytest.mark.parametrize("layout", ["rowell", "sell"])
def test_sharded_matches_reference_mesh(layout):
    """The port's 2-shard solve against the reference's
    ``jpcg_solve_batched(mesh=lane_mesh())`` on its 1-device mesh: the same
    statuses, iterations ±1, x within rtol=1e-4, atol=1e-6 (the tolerance
    of tests/test_backend_diff.py: the reference is not bitwise
    self-consistent on this tree's JAX)."""
    def bag(mod):
        return [mod.poisson_2d(6), mod.tridiagonal_spd(30),
                mod.diag_dominant_spd(50, nnz_per_row=5, dominance=1.3,
                                      seed=2),
                mod.powerlaw_spd(60, alpha=2.1, seed=4),
                mod.random_spd(24, cond=30.0, seed=9)]
    kw = dict(tol=1e-12, maxiter=500, layout=layout, **BK)
    ref = ref_solve_batched(bag(ref_sparse), mesh=ref_lane_mesh(), **kw)
    got = jpcg_solve_batched(bag(port_sparse), mesh=cpu_mesh(2), **kw)
    for g, (r, o) in enumerate(zip(got, ref)):
        assert r.status == o.status == "CONVERGED", g
        assert abs(r.iterations - o.iterations) <= 1, g
        np.testing.assert_allclose(r.x.numpy(), np.asarray(o.x), rtol=1e-4,
                                   atol=1e-6)
