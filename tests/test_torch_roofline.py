"""The port's roofline package against the reference's, on the CPU (the
counterpart of ``tests/test_roofline.py``).

* ``count_torch`` against the reference's HLO walker: a matmul's flops
  exactly 2·M·K·N and its bytes equal to the walker's, as for any single
  op; a 13-step Python loop counted 13 times (what the walker's trip-count
  parsing exists for); an unfused elementwise loop never under the
  walker's post-fusion bytes; a small gemma3-1b forward, matmul flops
  within 1 % of the walker's and total flops within 2 % (the two count
  elementwise work over different spellings: XLA's fused, simplified HLO
  and eager ATen ops; matmuls are ~98 % of the flops here).
* The ring model on the reference's three-op example, and a real
  ``all_reduce`` on gloo with 2 rank processes.
* ``roofline_terms`` and the report's strings equal to the reference's
  under a ``Hardware`` built from ``V5E``'s numbers; ``mfu_at_roofline``
  priced at the hardware the terms were priced with.
* The solver's analytic terms as the reference's Table 5 benchmark
  prices an iteration.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

import repro.roofline as ref_roofline
import repro.roofline.hlo_cost as ref_hlo_cost
from repro.core.precision import SCHEMES as REF_SCHEMES
from repro.core.vsr import schedule as ref_schedule
from repro.roofline.hlo_bytes import collective_bytes as ref_collective_bytes
from repro.roofline.hlo_bytes import parse_collectives as ref_parse
from repro.roofline.model import V5E
from repro.sparse.stacking import index_bytes_for as ref_index_bytes_for

import repro_torch.roofline as roofline
from repro_torch.roofline import (H100, Hardware, collective_bytes,
                                  count_torch, format_table, load_results,
                                  one_liner, parse_collectives,
                                  roofline_terms, solver_terms)
from repro_torch.roofline import torch_cost

SRC = str(Path(__file__).resolve().parents[1] / "src")
#: seconds a gloo rank may take before its test fails
TIMEOUT = 120
#: V5E's numbers in the port's ``Hardware``, with its per-dtype ratios
V5E_PORT = Hardware(name=V5E.name, peak_bf16_flops=V5E.peak_bf16_flops,
                    hbm_bw=V5E.hbm_bw, ici_link_bw=V5E.ici_link_bw,
                    ici_links=V5E.ici_links, hbm_bytes=V5E.hbm_bytes,
                    peaks=(("fp32", V5E.peak_flops("f32")),
                           ("fp64", V5E.peak_flops("f64"))))


def _hlo(f, *specs):
    return jax.jit(f).lower(*specs).compile().as_text()


def _f32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


# --------------------------------------------------------------- counter
def test_matmul_flops_exact_and_bytes_equal():
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    w = count_torch(lambda: a @ b)
    ref = ref_hlo_cost.walk_hlo(_hlo(lambda x, y: x @ y, _f32(64, 128),
                                     _f32(128, 32)))
    assert w.flops == 2 * 64 * 128 * 32
    assert w.hbm_bytes == ref.hbm_bytes == (64 * 128 + 128 * 32
                                            + 64 * 32) * 4


def test_single_op_bytes_equal_the_walker():
    x = torch.randn(1024, 1024)
    w = count_torch(torch.tanh, x)
    ref = ref_hlo_cost.walk_hlo(_hlo(jnp.tanh, _f32(1024, 1024)))
    assert (w.flops, w.transcendentals, w.hbm_bytes) == \
        (ref.flops, ref.transcendentals, ref.hbm_bytes)


def test_loop_multiplicity():
    """A 13-step Python loop of matmul + tanh counts 13 times: exactly
    13 · (2·64³ + 64²) flops and 13·64·64 transcendentals; the reference
    walker's scan within 0.1 % (it also counts the loop counter)."""
    def f(x):
        for _ in range(13):
            x = torch.tanh(x @ x)
        return x

    w = count_torch(f, torch.randn(64, 64))
    assert w.flops == 13 * (2 * 64 ** 3 + 64 * 64)
    assert w.transcendentals == 13 * 64 * 64

    def g(x):
        def body(c, _):
            return jnp.tanh(c @ c), None
        return jax.lax.scan(body, x, None, length=13)[0]

    ref = ref_hlo_cost.walk_hlo(_hlo(g, _f32(64, 64)))
    assert ref.transcendentals == w.transcendentals
    assert w.flops == pytest.approx(ref.flops, rel=1e-3)


def test_nested_loops_multiply():
    def f(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ x
        return x

    assert count_torch(f, torch.randn(32, 32)).flops == 15 * 2 * 32 ** 3


def test_unfused_bytes_never_under_the_walkers():
    """Eager ops are not fused: ``x * 2 + 1`` ten times reads and writes
    4 MiB twice a step, where the walker's fused count does it once."""
    def f(x):
        for _ in range(10):
            x = x * 2.0 + 1.0
        return x

    w = count_torch(f, torch.randn(1024, 1024))

    def g(x):
        def body(c, _):
            return c * 2.0 + 1.0, None
        return jax.lax.scan(body, x, None, length=10)[0]

    ref = ref_hlo_cost.walk_hlo(_hlo(g, _f32(1024, 1024)))
    assert w.hbm_bytes == 10 * 2 * 2 * 4 * 1024 * 1024
    assert w.hbm_bytes >= ref.hbm_bytes >= 10 * 2 * 4 * 1024 * 1024 * 0.9
    assert w.flops == 10 * 2 * 1024 * 1024


def test_views_move_no_bytes():
    x = torch.randn(64, 32)
    w = count_torch(lambda: x.t().reshape(32, 64)[:, :8].unsqueeze(0))
    assert w.hbm_bytes == 0 and w.flops == 0


def test_backward_counted():
    """Autograd's backward ops dispatch too: a linear layer's step counts
    three matmuls."""
    x = torch.randn(16, 32, requires_grad=True)
    lin = torch.nn.Linear(32, 8, bias=False)
    w = count_torch(lambda: lin(x).sum().backward())
    assert w.flops == 3 * 2 * 16 * 32 * 8 + 16 * 8     # and the sum


def test_gemma_forward_matches_the_walker(monkeypatch):
    from repro.configs import get_config as ref_get_config
    from repro.models import api as ref_api
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import api
    rc, pc = ref_get_config("gemma3-1b").reduced(), \
        get_config("gemma3-1b").reduced()
    rp = ref_api.init_params(rc, jax.random.PRNGKey(0))
    tp = convert.lm_params_to_torch(rp, pc, device="cpu")
    tok = np.random.default_rng(1).integers(0, rc.vocab, (2, 80))
    text = jax.jit(ref_api.forward_logits, static_argnums=1).lower(
        rp, rc, {"tokens": jnp.asarray(tok)}).compile().as_text()

    def fwd():
        return api.forward_logits(tp, pc, {"tokens": torch.from_numpy(tok)})

    ref, got = ref_hlo_cost.walk_hlo(text), count_torch(fwd)
    assert got.flops == pytest.approx(ref.flops, rel=0.02)
    assert got.hbm_bytes >= ref.hbm_bytes
    # matmuls alone: the walker without its elementwise and reduce ops,
    # the counter without its elementwise and reduce tables
    for mod, names in ((ref_hlo_cost, ("_ELEMENTWISE", "_TRANSCENDENTAL")),
                       (torch_cost, ("_PER_OUT", "_PER_IN"))):
        for name in names:
            monkeypatch.setattr(mod, name, type(getattr(mod, name))())
    ref_mm = ref_hlo_cost.walk_hlo(
        text.replace(" reduce(", " reduce-off(")
        .replace(" reduce-window(", " reduce-window-off(")).flops
    got_mm = count_torch(fwd).flops
    assert got_mm == pytest.approx(ref_mm, rel=0.01)
    assert got_mm > 0.9 * got.flops


# ----------------------------------------------------------- collectives
def test_ring_model_on_the_references_example():
    hlo = """
ENTRY %main (p: f32[16,16]) -> f32[16,16] {
  %ar = f32[64,256]{1,0} all-reduce(%x), replica_groups=[4,2]<=[8]
  %ag = f32[64,256]{1,0} all-gather(%y), replica_groups=[2,4]<=[8]
  %cp = f32[8,8]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
}
"""
    rb = 64 * 256 * 4
    ops = parse_collectives([("all-reduce", rb, 2), ("all-gather", rb, 4),
                             ("collective-permute", 8 * 8 * 4, None)],
                            default_group=8)
    ref = ref_parse(hlo, default_group=8)
    assert [(o.kind, o.result_bytes, o.group_size, o.wire_bytes)
            for o in ops] == [(o.kind, o.result_bytes, o.group_size,
                               o.wire_bytes) for o in ref]
    assert collective_bytes(ops) == ref_collective_bytes(hlo, 8)
    assert ops[0].wire_bytes == int(2 * 0.5 * rb)


_RANK = r"""
import datetime, json, os
import torch
import torch.distributed as dist
from repro_torch.roofline import count_torch
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["PG_INIT"],
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
x = torch.full((32, 64), float(rank + 1))
w = count_torch(dist.all_reduce, x)
dist.destroy_process_group()
print(json.dumps(dict(wire=w.wire_bytes, n=w.collective_count,
                      kinds=w.wire_by_kind, sum=float(x[0, 0]))))
"""


def test_real_all_reduce_counted_on_gloo(tmp_path):
    world = 2
    env = dict(os.environ, PYTHONPATH=SRC, WORLD_SIZE=str(world),
               PG_INIT=f"file://{tmp_path}/pg")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    rb = 32 * 64 * 4
    for o in outs:
        assert o["sum"] == 3.0                  # the collective ran
        assert o["n"] == 1
        assert o["wire"] == 2 * (world - 1) / world * rb
        assert o["kinds"] == {"all-reduce": o["wire"]}


def test_collective_without_a_readable_group_raises():
    """An eager collective always carries its group; one that cannot be
    read raises, naming the op, rather than pricing a group of 1 at 0
    wire bytes."""
    from repro_torch.roofline.torch_cost import _group_size
    with pytest.raises(ValueError, match="c10d::allreduce_"):
        _group_size("c10d::allreduce_", (torch.zeros(4), "sum"))


# ---------------------------------------------------------------- model
COSTS = [({"flops": 197e12, "bytes accessed": 819e9}, 0.0, {}),
         ({"flops": 1.0, "bytes accessed": 1.0}, 200e9 * 10, {}),
         ({"flops": 1e12, "bytes accessed": 1.0}, 0.0,
          dict(chips=256, model_flops=128e12)),
         ({"flops": 3e13, "bytes accessed": 2e12}, 4e9,
          dict(model_flops=1e13, dtype="f32"))]


@pytest.mark.parametrize("cost, wire, kw", COSTS)
def test_terms_equal_the_references_under_v5e(cost, wire, kw):
    got = roofline_terms(cost, wire, hw=V5E_PORT, **kw).as_dict()
    want = ref_roofline.roofline_terms(cost, wire, hw=V5E, **kw).as_dict()
    assert got.pop("peak_flops") == V5E.peak_flops(kw.get("dtype", "bf16"))
    if kw.get("dtype", "bf16") != "bf16":
        # the reference divides MFU by V5E's bf16 peak whatever the dtype
        got.pop("mfu_at_roofline"), want.pop("mfu_at_roofline")
    assert got == want


def test_mfu_priced_at_the_terms_own_peak():
    cost = {"flops": 4e12, "bytes accessed": 1e9}
    t = roofline_terms(cost, 0.0, hw=H100, model_flops=2e12)
    assert t.peak_flops == H100.peak_bf16_flops == 989.4e12
    assert t.mfu_at_roofline == pytest.approx(
        2e12 / (t.bound_s * 989.4e12))
    ref = ref_roofline.roofline_terms(cost, 0.0, hw=V5E, model_flops=2e12)
    assert ref.mfu_at_roofline == pytest.approx(
        2e12 / (ref.bound_s * V5E.peak_bf16_flops))
    assert t.useful_fraction == ref.useful_fraction == 0.5


def test_h100_constants():
    assert (H100.peak_bf16_flops, H100.hbm_bw, H100.hbm_bytes) == \
        (989.4e12, 3.35e12, 80e9)
    assert H100.ici_links * H100.ici_link_bw == 450e9     # NVLink, each way
    assert H100.peak_flops("fp32") == H100.peak_flops("float32") == 66.9e12
    assert H100.peak_flops("f64") == H100.peak_flops("torch.float64") \
        == 33.5e12
    assert H100.peak_flops("fp64_tc") == 66.9e12
    assert H100.peak_flops("tf32") == 494.7e12          # the tensor cores
    assert H100.peak_flops("bfloat16") == 989.4e12
    with pytest.raises(ValueError, match="int8"):
        H100.peak_flops("int8")
    assert roofline.model_flops_train(1e9, 1e6) == \
        ref_roofline.model_flops_train(1e9, 1e6) == 6e15
    assert roofline.model_flops_decode(7, 3) == \
        ref_roofline.model_flops_decode(7, 3)


def test_exports():
    want = set(ref_roofline.__all__) - {"V5E"} | {"H100"}
    assert want <= set(roofline.__all__)
    assert not hasattr(roofline, "V5E")


# --------------------------------------------------------------- report
def _records():
    out = []
    for i, (cost, wire, kw) in enumerate(COSTS):
        t = roofline_terms(cost, wire, hw=V5E_PORT, **kw).as_dict()
        t.pop("peak_flops")
        out.append({"arch": f"arch-{i}", "shape": ["train_4k", "decode",
                                                   "prefill_32k", "x"][i],
                    "roofline": t})
    out.append({"arch": "empty", "shape": "none", "roofline": {}})
    return out


def test_report_strings_identical(tmp_path):
    recs = _records()
    assert format_table(recs) == ref_roofline.format_table(recs)
    for r in recs:
        assert one_liner(r) == ref_roofline.one_liner(r)
    for i, r in enumerate(recs):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(r))
    (tmp_path / "notes.txt").write_text("skipped")
    assert load_results(str(tmp_path)) == \
        ref_roofline.load_results(str(tmp_path)) == recs
    assert load_results(str(tmp_path / "missing")) == []


# --------------------------------------------------------------- solver
@pytest.mark.parametrize("n_side", [40, 200])
@pytest.mark.parametrize("scheme", sorted(REF_SCHEMES))
def test_solver_terms_as_table5_prices_them(scheme, n_side):
    """Bytes an iteration: the min-traffic schedule's vector accesses at
    ``vector_bytes`` plus a value and an index a nonzero (int16 below
    2^15 bucketed rows, int32 at 40,000); flops 2·nnz + 13·n."""
    from repro_torch.sparse import poisson_2d
    a = poisson_2d(n_side)
    n, nnz = a.shape[0], a.nnz
    s, sch = ref_schedule(policy="min_traffic"), REF_SCHEMES[scheme]
    want_bytes = ((s.n_reads + s.n_writes) * n * sch.vector_bytes
                  + nnz * sch.nonzero_stream_bytes(
                      index_bytes=ref_index_bytes_for(n)))
    t = solver_terms(a, scheme)
    assert t.hbm_bytes == want_bytes
    assert t.flops == 2 * nnz + 3 * 2 * n + 3 * 2 * n + n
    assert t.dominant == "memory" and t.collective_s == 0
    assert t.memory_s == want_bytes / 3.35e12
    assert t.useful_fraction == 1.0


@pytest.mark.parametrize("scheme", sorted(REF_SCHEMES))
def test_solver_terms_over_a_stored_stream(scheme):
    """``matrix_bytes`` replaces the per-nonzero stream and leaves the
    13 vector accesses and the flops as they were."""
    from repro_torch.sparse import csr_to_ellpack, poisson_2d
    a = poisson_2d(40)
    m = csr_to_ellpack(a)
    sch = REF_SCHEMES[scheme]
    stored = m.stream_bytes(value_bytes=sch.matrix_bytes,
                            index_bytes=m.local_cols.dtype.itemsize)
    s = ref_schedule(policy="min_traffic")
    t = solver_terms(a, scheme, matrix_bytes=stored)
    assert t.hbm_bytes == (s.n_reads + s.n_writes) * a.shape[0] \
        * sch.vector_bytes + stored
    assert t.flops == solver_terms(a, scheme).flops
