"""The dry run's ``REPRO_DRYRUN_OPTS`` switches in the port
(``repro_torch.launch.dryrun``) against the reference's, on the CPU.

``bf16_gather`` — one train step of a 2-layer ``gemma3-1b.reduced()``
(fp32 compute), B 32 × S 16 from ``default_rng(0)``, 16 microbatches, the
dry run's AdamW (lr 3e-4):

* the reference's step runs in a subprocess: its own ``build_cell`` train
  step under ``jax.jit``, with and without the switch, on a 2×2 mesh of
  Auto axes over 4 host devices (``XLA_FLAGS`` set after importing
  ``repro.launch.dryrun``, which sets 512 at import; the reference's
  ``make_mesh`` builds Explicit axes, which its sharding constraints
  refuse), B 32 so that a data shard holds 16 sequences;
* the port's step runs unsharded from the same parameters (carried across
  by ``repro_torch.convert``) through the functions the dry run counts:
  :func:`~repro_torch.launch.dryrun.bf16_view` once, then
  :func:`~repro_torch.train.loop.accumulate` per microbatch (the train
  step's own), then ``adamw_update``;
* the tolerance: the loss within 2e-4 (the switch moves it 1.6e-3), and
  every updated parameter within 1e-4 but for at most 64 entries in the
  whole model.  Those entries are where a gradient lies within its
  rounding of zero: Adam's first step g/(|g| + eps) moves a parameter by
  ±lr whatever the gradient's size, so a rounding that flips its sign
  moves it 2·lr = 6e-4.  The switch flips 551 such entries, across every
  matrix; the port's bf16 step flips 16 against the reference's, all in
  the tied embedding, whose two bf16 cotangents XLA sums with excess
  precision.  The port's step without the switch lies outside the
  tolerance against the reference's with it, and the other way round;
* the cast rule leaf by leaf: the view holds exactly the leaves the
  reference casts, ``p.ndim >= 2 and p.dtype == float32`` on its stacked
  tree (the per-layer norm gains, not ``ln_f.g``).

In a dry-run subprocess (rank 0 of a fake group of 256 ranks, meta
tensors): ``OPTS`` read from the environment as the reference reads it;
every cast leaf a bf16 DTensor with its parameter's placements, and the
cast counted with no collective; a 2-layer gemma3-1b train cell with the
switch against one without; for a 2-layer mamba2 the counted flops of
the prefill and train cells falling from chunk 256 to 128 to 64, and the
decode cell's counts unchanged; the chunk set for a config's name too.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.train.loop import _micro, accumulate
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update

SRC = str(Path(__file__).resolve().parents[1] / "src")
#: seconds a subprocess may take before its test fails
TIMEOUT = 300
LAYERS, B, S, K = 2, 32, 16, 16
LR = 3e-4                  # the dry run's
LOSS_ATOL = 2e-4
PARAM_ATOL = 1e-4
#: entries in the whole model allowed past PARAM_ATOL (sign flips of
#: gradients within their rounding of zero; see the module docstring)
FLIPS_MAX = 64

_REF = r"""
import dataclasses, os, sys
import numpy as np
import repro.launch.dryrun as D
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models import init_params
from repro.train.optim import AdamWConfig, adamw_init
cfg = dataclasses.replace(get_config("gemma3-1b").reduced(), n_layers=%d)
D.get_config = lambda arch: cfg
assert len(jax.devices()) == 4
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
params = init_params(cfg, jax.random.PRNGKey(0))
opt = adamw_init(params, AdamWConfig())
rng = np.random.default_rng(0)
batch = {k: jnp.asarray(rng.integers(0, cfg.vocab, (%d, %d)), jnp.int32)
         for k in ("tokens", "labels")}
out = {}
for tag, opts in (("plain", frozenset()), ("bf16", frozenset({"bf16_gather"}))):
    D.OPTS = opts
    fn = D.build_cell("gemma3-1b", "train_4k", mesh)[0]
    new_p, _, loss = jax.jit(fn)(params, opt, batch, jnp.asarray(0, jnp.int32))
    out[tag + "/loss"] = np.asarray(loss)
    for path, leaf in jax.tree_util.tree_flatten_with_path(new_p)[0]:
        out[tag + "/" + ".".join(k.key for k in path)] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
""" % (LAYERS, B, S)


def _cfgs():
    return (dataclasses.replace(get_config("gemma3-1b").reduced(),
                                n_layers=LAYERS),
            dataclasses.replace(ref_get_config("gemma3-1b").reduced(),
                                n_layers=LAYERS))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``{"plain" | "bf16": (loss, {port name: updated parameter})}``."""
    path = tmp_path_factory.mktemp("ref") / "step.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF, str(path)], env=env,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    cfg, _ = _cfgs()
    z = np.load(path)
    out = {}
    for tag in ("plain", "bf16"):
        flat = {k.split("/", 1)[1]: z[k] for k in z.files
                if k.startswith(tag + "/") and not k.endswith("/loss")}
        out[tag] = (float(z[tag + "/loss"]), convert._lm_state(flat, cfg))
    return out


@pytest.fixture(scope="module")
def port():
    """The port's step from the reference's initial parameters, with and
    without the switch: ``{tag: (loss, {name: updated parameter})}``."""
    cfg, rcfg = _cfgs()
    init = ref_init_params(rcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
             for k in ("tokens", "labels")}
    out = {}
    for tag in ("plain", "bf16"):
        model = convert.lm_params_to_torch(init, cfg, device="cpu")
        opt = AdamWConfig()
        state = adamw_init(model, opt)
        acc = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        view = dryrun.bf16_view(model) if tag == "bf16" else None
        total = torch.zeros(())
        for i in range(K):
            micro = {k: _micro(x, i, K) for k, x in batch.items()}
            total = total + accumulate(model, cfg, micro, acc, view)
        adamw_update({n: g.div_(K) for n, g in acc.items()}, state, model,
                     opt, torch.tensor(LR))
        out[tag] = (float(total / K),
                    {n: p.detach().numpy().copy()
                     for n, p in model.named_parameters()})
    return out


def _misses(got, want):
    """(|Δloss|, entries past PARAM_ATOL, largest |Δ|) of two steps."""
    (gl, gp), (wl, wp) = got, want
    assert set(gp) == set(wp)
    flips = sum(int((np.abs(gp[n] - wp[n]) > PARAM_ATOL).sum()) for n in gp)
    worst = max(float(np.abs(gp[n] - wp[n]).max()) for n in gp)
    return abs(gl - wl), flips, worst


def _within(got, want) -> bool:
    dl, flips, worst = _misses(got, want)
    return dl <= LOSS_ATOL and flips <= FLIPS_MAX \
        and worst <= 2 * LR * 1.01


@pytest.mark.parametrize("tag", ["plain", "bf16"])
def test_port_step_matches_the_reference(reference, port, tag):
    assert _within(port[tag], reference[tag]), _misses(port[tag],
                                                       reference[tag])


@pytest.mark.parametrize("port_tag,ref_tag", [("plain", "bf16"),
                                              ("bf16", "plain")])
def test_tolerance_tells_the_switch_apart(reference, port, port_tag,
                                          ref_tag):
    dl, flips, _ = _misses(port[port_tag], reference[ref_tag])
    assert not _within(port[port_tag], reference[ref_tag])
    assert dl > 4 * LOSS_ATOL and flips > 4 * FLIPS_MAX, (dl, flips)


def test_the_switch_changes_the_reference_step(reference):
    dl, flips, _ = _misses(reference["plain"], reference["bf16"])
    assert dl > 4 * LOSS_ATOL and flips > 4 * FLIPS_MAX, (dl, flips)


def test_cast_rule_is_the_reference_leaf_by_leaf():
    """The view's names are the port names of the reference leaves that
    its ``bf16_gather`` casts."""
    cfg, rcfg = _cfgs()
    shapes = jax.eval_shape(lambda k: ref_init_params(rcfg, k),
                            jax.ShapeDtypeStruct((2,), np.uint32))
    cast = {".".join(k.key for k in path)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
            if len(leaf.shape) >= 2 and leaf.dtype == np.float32}
    # the port's names of those leaves (a stacked one: every layer's)
    want = set(convert._lm_state({n: np.zeros(LAYERS) for n in cast}, cfg))
    view = dryrun.bf16_view(convert.lm_params_to_torch(
        ref_init_params(rcfg, jax.random.PRNGKey(0)), cfg, device="cpu"))
    assert set(view) == want
    assert "layers.0.ln1.g" in view and "ln_f.g" not in view
    assert all(t.dtype == torch.bfloat16 and t.grad_fn is None
               and not t.requires_grad for t in view.values())


# ------------------------------------------------------- the dry run
_DRY = r"""
import dataclasses, json
import torch
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import distribute
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import model_class
from repro_torch.roofline import counting
out = {"opts": sorted(dryrun.OPTS),
       "chunk_env": dryrun._with_opts(get_config("mamba2-780m")).ssm.chunk,
       "chunk_zamba2": dryrun._with_opts(get_config("zamba2-1.2b")).ssm.chunk}
gemma = dataclasses.replace(get_config("gemma3-1b"), n_layers=%d)
dryrun.start_fake_group(256)
mesh = make_production_mesh(multi_pod=False, device_type="cpu")
params = distribute(model_class(gemma)(gemma, device="meta"), mesh)
with counting() as walk:
    view = dryrun.bf16_view(params)
named = dict(params.named_parameters())
out["cast"] = {n: [isinstance(t, DTensor), str(t.dtype),
                   t.placements == named[n].placements,
                   any(p.is_shard() for p in t.placements)]
               for n, t in view.items()}
out["cast_walk"] = [walk.collective_count, walk.wire_bytes]
cells = {}
for opts in ((), ("bf16_gather",)):
    dryrun.OPTS = frozenset(opts)
    cells["gemma/" + ",".join(opts)] = dryrun.run_cell(gemma, "train_4k",
                                                       "single", save=False)
mamba = dataclasses.replace(get_config("mamba2-780m"), n_layers=%d)
for opts in ((), ("ssd_chunk128",), ("ssd_chunk64",),
             ("ssd_chunk128", "ssd_chunk64")):
    dryrun.OPTS = frozenset(opts)
    for shape in ("prefill_32k", "train_4k", "decode_32k"):
        cells[f"mamba/{','.join(opts)}/{shape}"] = dryrun.run_cell(
            mamba, shape, "single", save=False)
out["cells"] = cells
print(json.dumps(out))
""" % (LAYERS, LAYERS)


@pytest.fixture(scope="module")
def dry():
    env = dict(os.environ, PYTHONPATH=SRC,
               REPRO_DRYRUN_OPTS="ssd_chunk128,,nonsense,ssd_chunk64")
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", _DRY], env=env,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_opts_read_from_the_environment_as_the_reference(dry):
    """Comma-separated, empty names dropped, unknown names kept and
    ignored; ``ssd_chunk64`` wins over ``ssd_chunk128``, for a config
    looked up by name (mamba2, zamba2)."""
    assert dry["opts"] == ["nonsense", "ssd_chunk128", "ssd_chunk64"]
    assert dry["chunk_env"] == dry["chunk_zamba2"] == 64


def test_cast_leaves_keep_their_placements_without_a_collective(dry):
    cast = dry["cast"]
    assert "layers.0.ln1.g" in cast and "ln_f.g" not in cast
    assert "embed.e" in cast
    for name, (is_dt, dtype, same, _) in cast.items():
        assert is_dt and dtype == "torch.bfloat16" and same, name
    # the matrices are sharded, so the cast is of a shard
    assert any(sharded for *_, sharded in cast.values())
    assert dry["cast_walk"] == [0, 0]


def test_bf16_gather_train_cell(dry):
    """The switch's cell runs, its flops unchanged; the gradients'
    reduce-scatters and all-reduces move bf16, fewer bytes; the
    all-gathers move no more (``dense`` already casts each shard before
    its matmul)."""
    plain, cast = dry["cells"]["gemma/"], dry["cells"]["gemma/bf16_gather"]
    assert plain["status"] == cast["status"] == "OK"
    assert cast["cost"]["flops"] == plain["cost"]["flops"]
    pk, ck = (c["collectives"]["by_kind"] for c in (plain, cast))
    assert ck["reduce-scatter"] < pk["reduce-scatter"]
    assert ck["all-reduce"] < pk["all-reduce"]
    assert ck.get("all-gather", 0) <= pk.get("all-gather", 0)


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_ssd_chunk_cuts_the_counted_flops(dry, shape):
    cells = dry["cells"]
    flops = [cells[f"mamba/{o}/{shape}"]["cost"]["flops"]
             for o in ("", "ssd_chunk128", "ssd_chunk64")]
    assert all(cells[f"mamba/{o}/{shape}"]["status"] == "OK"
               for o in ("", "ssd_chunk128", "ssd_chunk64"))
    assert flops[0] > flops[1] > flops[2], flops
    assert cells[f"mamba/ssd_chunk128,ssd_chunk64/{shape}"]["cost"] \
        == cells[f"mamba/ssd_chunk64/{shape}"]["cost"]


def test_ssd_chunk_leaves_decode_alone(dry):
    cells = dry["cells"]
    base = cells["mamba//decode_32k"]
    for o in ("ssd_chunk128", "ssd_chunk64"):
        c = cells[f"mamba/{o}/decode_32k"]
        assert c["cost"] == base["cost"] and c["memory"] == base["memory"]
        assert c["collectives"] == base["collectives"]
