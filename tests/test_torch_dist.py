"""The row-distributed JPCG of the port (``torch.distributed``), on the CPU.

* ``partition_rows`` is byte for byte the reference's.
* gloo with 2, 4 and 8 ranks, each rank a process of its own (started
  here with a ``file://`` rendezvous in the test's temporary directory and
  a timeout of its own): ``vsr`` and ``pipelined`` solve ``poisson_2d(40)``;
  at 8 ranks the solve matches the port's own ``jpcg_solve``; halo and
  all-gather take the same iterations, halo sending under half the bytes;
  ``pipelined`` issues one all-reduce an iteration and ``vsr`` two.
* Against the reference's ``make_dist_solver`` on 8 forced host devices
  (a subprocess, as tests/test_distributed.py runs it).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.sparse as ref_sparse
from repro.sparse.partition import partition_rows as ref_partition_rows

import repro_torch.sparse as port_sparse
from repro_torch.sparse.partition import partition_rows

SRC = str(Path(__file__).resolve().parents[1] / "src")
BK = dict(block_rows=8, col_tile=16)
#: seconds a rank or the reference's subprocess may take before its test
#: fails (the whole file takes well under a minute)
TIMEOUT = 240


def _matrices(mod):
    return {"poisson": mod.poisson_2d(20),
            "diag": mod.diag_dominant_spd(300, nnz_per_row=7,
                                          dominance=1.3, seed=3),
            "powerlaw": mod.powerlaw_spd(200, alpha=2.1, seed=5)}


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", ["poisson", "diag", "powerlaw"])
def test_partition_byte_identical(name, n_shards):
    got = partition_rows(_matrices(port_sparse)[name], n_shards, **BK)
    want = ref_partition_rows(_matrices(ref_sparse)[name], n_shards, **BK)
    for field in ("tile_cols", "vals", "local_rows", "local_cols"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    for field in ("shape", "rows_per_shard", "block_rows", "col_tile", "nnz",
                  "halo_width", "halo_pad", "supports_halo", "n_shards",
                  "padded_rows", "padded_cols"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.tile_cols_halo().tobytes() == want.tile_cols_halo().tobytes()


def test_auto_selects_halo_for_stencil():
    part = partition_rows(port_sparse.poisson_2d(64), 8, block_rows=8,
                          col_tile=64)
    assert part.supports_halo and part.halo_width == 64
    assert part.halo_pad == 64 and part.halo_pad * 4 <= part.rows_per_shard


# ------------------------------------------------------------- gloo ranks
_RANK = r"""
import datetime, json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["PG_INIT"],
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.core.cg import jpcg_solve
from repro_torch.distributed import make_dist_solver
from repro_torch.distributed.cg_dist import collectives, reset_collectives
from repro_torch.sparse import csr_to_dense, poisson_2d

out = {}
for job in json.loads(os.environ["JOBS"]):
    a = poisson_2d(job["nx"])
    n = a.shape[0]
    s = make_dist_solver(a, scheme="mixed_v3", method=job["method"],
                         tol=1e-12, maxiter=4000, block_rows=8,
                         col_tile=job["col_tile"], comm=job["comm"],
                         device="cpu")
    reset_collectives()
    x, it, rr = s.solve(np.ones(n), np.zeros(n), a.diagonal())
    c = collectives()
    x = x.numpy()
    row = dict(iters=it, rr=rr, comm=s.comm, x=x.tolist(), counts=c,
               resid=float(np.linalg.norm(csr_to_dense(a) @ x - 1.0)))
    if job.get("single"):
        ref = jpcg_solve(a, tol=1e-12, maxiter=4000, block_rows=8,
                         col_tile=128, method=job["method"], device="cpu")
        row.update(single_iters=ref.iterations,
                   single_err=float(np.abs(x - ref.x.numpy()).max()))
    out[job["key"]] = row
torch.cuda.is_available = lambda: False
try:
    make_dist_solver(poisson_2d(4), block_rows=8, col_tile=16)
    out["default_device"] = "ran"
except RuntimeError as e:
    out["default_device"] = str(e)
dist.destroy_process_group()
if rank == 0:
    print(json.dumps(out))
"""


def _job(key, nx, method, comm="allgather", col_tile=128, single=False):
    return dict(key=key, nx=nx, method=method, comm=comm,
                col_tile=col_tile, single=single)


#: world size -> the solves its ranks run
JOBS = {
    2: [_job("vsr", 40, "vsr"), _job("pipelined", 40, "pipelined")],
    4: [_job("vsr", 40, "vsr"), _job("pipelined", 40, "pipelined")],
    8: [_job("vsr", 40, "vsr"), _job("pipelined", 40, "pipelined"),
        _job("single", 32, "vsr", single=True),
        _job("single_pipelined", 32, "pipelined", single=True),
        _job("allgather64", 64, "vsr", col_tile=64),
        _job("halo64", 64, "vsr", comm="halo", col_tile=64)],
}


def _launch(world, jobs, tmp):
    env = dict(os.environ, PYTHONPATH=SRC, WORLD_SIZE=str(world),
               PG_INIT=f"file://{tmp}/pg{world}", JOBS=json.dumps(jobs))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:                      # a rank that hangs is killed
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pg")
    return {w: _launch(w, jobs, tmp) for w, jobs in JOBS.items()}


@pytest.mark.parametrize("method", ["vsr", "pipelined"])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_solves_poisson(gloo, world, method):
    row = gloo[world][method]
    assert row["comm"] == "allgather"
    assert row["rr"] <= 1e-12
    assert row["resid"] < 1e-4


def test_matches_port_single_system_solve(gloo):
    row = gloo[8]["single"]
    assert row["iters"] == row["single_iters"]
    assert row["single_err"] < 1e-9


def test_pipelined_matches_port_single_system_solve(gloo):
    """The distributed ``pipelined`` runs ``jpcg_solve``'s loop over 8
    ranks: the same iterations, and x within 1e-9 (its dots sum in
    another order)."""
    row = gloo[8]["single_pipelined"]
    assert row["iters"] == row["single_iters"]
    assert row["single_err"] < 1e-9


def test_halo_equals_allgather(gloo):
    halo, ag = gloo[8]["halo64"], gloo[8]["allgather64"]
    assert halo["comm"] == "halo" and ag["comm"] == "allgather"
    assert halo["iters"] == ag["iters"]
    assert halo["resid"] < 1e-4
    assert halo["counts"]["halo"] == halo["iters"] + 1   # one per SpMV
    assert halo["counts"]["bytes_sent"] < 0.5 * ag["counts"]["bytes_sent"]


@pytest.mark.parametrize("world", [2, 4, 8])
def test_reductions_per_iteration(gloo, world):
    """``pipelined``: one all-reduce an iteration; ``vsr``: two; each
    one more at the start."""
    vsr, pipe = gloo[world]["vsr"], gloo[world]["pipelined"]
    assert pipe["counts"]["all_reduce"] == pipe["iters"] + 1
    assert vsr["counts"]["all_reduce"] == 2 * vsr["iters"] + 1
    # an all-gather per SpMV (pipelined: two more per residual
    # replacement, every 50 iterations), and one of x at the end
    assert vsr["counts"]["all_gather"] == vsr["iters"] + 2
    assert pipe["counts"]["all_gather"] == \
        pipe["iters"] + 3 + 2 * (pipe["iters"] // 50)


def test_default_device_needs_a_card(gloo):
    assert "device='cpu'" in gloo[2]["default_device"]


def test_needs_a_process_group():
    import torch.distributed as dist
    from repro_torch.distributed import make_dist_solver
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_dist_solver(port_sparse.poisson_2d(4), device="cpu")


# --------------------------------------------------- against the reference
_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.sparse import poisson_2d
from repro.distributed import make_dist_solver
mesh = jax.make_mesh((8,), ("rows",))
a = poisson_2d(40)
out = {}
for method in ("vsr", "pipelined"):
    s = make_dist_solver(a, mesh, scheme="mixed_v3", method=method,
                         tol=1e-12, maxiter=4000, block_rows=8,
                         col_tile=128)
    x, it, rr = s.solve(jnp.ones(1600), jnp.zeros(1600),
                        jnp.asarray(a.diagonal()))
    out[method] = dict(iters=int(it), x=np.asarray(x).tolist())
print(json.dumps({"devices": jax.device_count(), **out}))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _REF], env=env,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["devices"] == 8
    return out


def test_vsr_matches_reference_8_devices(gloo, reference):
    got, want = gloo[8]["vsr"], reference["vsr"]
    assert abs(got["iters"] - want["iters"]) <= 1
    assert np.abs(np.array(got["x"]) - np.array(want["x"])).max() < 1e-9


def test_pipelined_matches_reference_8_devices(gloo, reference):
    """The port replaces the residual at iteration 50, the reference's
    distributed loop never; the solves agree within the solve tolerance."""
    got, want = gloo[8]["pipelined"], reference["pipelined"]
    assert abs(got["iters"] - want["iters"]) <= 2
    np.testing.assert_allclose(got["x"], want["x"], rtol=1e-4, atol=1e-6)

