"""The sharded train step (``make_train_step(cfg, mesh)``), checkpoints
across meshes and ``elastic_restore``, on the CPU over gloo.

One launch of 4 rank processes (a ``file://`` rendezvous in the test's
temporary directory, a timeout of its own, as tests/test_torch_dist.py
starts them) and, beside it, one of world size 1.  A tiny config of each
family (dense, moe, ssm, hybrid, encdec; 1–2 layers, d_model 32, fp32),
its parameters drawn once here and loaded by every rank, B 8, S 16:

* two variants whose shapes the meshes do not divide, run as the
  families are: ``vocab63`` (the encdec config with whisper's case of a
  vocab the model axis does not divide, 63, and 3 heads, which it does
  not divide either; on (2, 2) the table and the heads are replicated,
  the batch sharded) and ``batch5`` (the dense config at B 5, which
  neither data axis divides; the batch is replicated);
* on the (2, 2) and (4, 1) meshes: the gradients of the sharded step
  within rtol 1e-4 and 1e-5 of the largest entry of the unsharded port's,
  the loss within rel 1e-5; two sharded steps against two unsharded ones
  with AdamW at ``eps = 1``, which keeps the update smooth in the
  gradient (at 1e-8 the first step is sign(g), which turns a last-bit
  difference of a sum into ±lr): the losses within rel 1e-5 and the
  parameters and moments within 1e-6;
* the losses of those two steps within rel 1e-4 of the reference's
  unsharded ``make_train_step`` on the same parameters (carried across by
  ``repro_torch.convert``);
* at world size 1, on the (1, 1) mesh with the default AdamW (bf16
  moments): the loss, every parameter and both moments of two steps bit
  for bit the unsharded step's, with 1 and 2 microbatches;
* save on (2, 2), then ``elastic_restore`` on (1, 4), ``restore(
  shardings=)`` on (2, 2) and an unsharded ``restore``: bit for bit, each
  leaf laid out by ``param_specs`` on its mesh;
* three decode steps of the dense and hybrid configs on (2, 2), the cache
  sharded by ``cache_specs`` (batch on ``data``, length, heads or
  channels on ``model``), against the unsharded model: logits and caches
  within 1e-5 of their largest entry;
* the ``Trainer`` on the sharded step at world size 1: a resume from its
  step-2 checkpoint (DTensor leaves) into other parameters continues bit
  for bit;
* 2 microbatches of a batch of 16 on (2, 2) and (4, 1) against the
  unsharded step's 2; a count that does not divide the per-shard batch
  raises ``ValueError``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models.api import init_params

SRC = str(Path(__file__).resolve().parents[1] / "src")
#: seconds a rank may take before the test fails
TIMEOUT = 300
FAMILIES = {"dense": "gemma3-1b", "moe": "granite-moe-1b-a400m",
            "ssm": "mamba2-780m", "hybrid": "zamba2-1.2b",
            "encdec": "whisper-base"}
#: name: (family, config overrides, batch)
VARIANTS = {"vocab63": ("encdec", dict(vocab=63, n_heads=3, n_kv_heads=3),
                        8),
            "batch5": ("dense", {}, 5)}
B, S, LR = 8, 16, 1e-2


def _tiny(arch):
    c = get_config(arch).reduced()
    return dataclasses.replace(
        c, name=c.name + "-tiny",
        n_layers=1 if c.encoder is not None else 2,
        attn_every=2 if c.attn_every else 0,
        d_model=32, n_heads=4, n_kv_heads=min(c.n_kv_heads, 2), head_dim=8,
        d_ff=64, vocab=64,
        sliding_window=8 if c.sliding_window else None,
        moe=c.moe and dataclasses.replace(c.moe, n_experts=4),
        ssm=c.ssm and dataclasses.replace(c.ssm, d_state=8, headdim=8,
                                          chunk=8),
        encoder=c.encoder and dataclasses.replace(c.encoder, n_layers=1,
                                                  n_ctx=16))


def _ref_cfg(cfg):
    from repro.models import config as RCfg
    kw = dataclasses.asdict(cfg)
    kw["moe"] = cfg.moe and RCfg.MoEConfig(**kw["moe"])
    kw["ssm"] = cfg.ssm and RCfg.SSMConfig(**kw["ssm"])
    kw["encoder"] = cfg.encoder and RCfg.EncoderConfig(**kw["encoder"])
    return RCfg.ModelConfig(**kw)


def _batch(cfg, seed, b=B):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (b, S), generator=g)
    out = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    if cfg.encoder is not None:
        out["audio_embeds"] = torch.randn(b, cfg.encoder.n_ctx, cfg.d_model,
                                          generator=g)
    return out


_RANK = r"""
import datetime, json, os
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["PG_INIT"],
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.core.gn import param_dict
from repro_torch.distributed.hints import sharding_hints
from repro_torch.distributed.sharding import (_map_named, batch_specs,
                                              cache_specs, distribute,
                                              distribute_tree,
                                              named_shardings, param_specs)
from repro_torch.models.api import decode_step, init_cache
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.api import model_class
from repro_torch.train import AdamWConfig, adamw_init, make_train_step
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop
from repro_torch.train.fault import elastic_restore

TMP, LR = os.environ["TMP"], float(os.environ["LR"])
job = json.loads(os.environ["JOB"])
sched = lambda s: torch.tensor(LR)


def load(fam):
    d = torch.load(os.path.join(TMP, fam + ".pt"), weights_only=False)
    m = model_class(d["cfg"])(d["cfg"], device="cpu")
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(d["params"][n])
    return d["cfg"], m, d["batch"]


def err(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.


def full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def same(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8)
        if a.dtype == torch.bfloat16 else a, b.view(torch.uint8)
        if b.dtype == torch.bfloat16 else b)


def steps(cfg, ref, sh, mesh, batch, opt, k):
    st_ref = make_train_step(cfg, opt=opt, schedule=sched, microbatches=k,
                             device="cpu")
    st_sh = make_train_step(cfg, mesh, opt=opt, schedule=sched,
                            microbatches=k)(batch)
    o_ref, o_sh = adamw_init(ref, opt), adamw_init(sh, opt)
    losses, bit = [], True
    for s in range(2):
        ref, o_ref, m1 = st_ref(ref, o_ref, batch, s)
        sh, o_sh, m2 = st_sh(sh, o_sh, batch, s)
        losses.append([float(m1["loss"]), float(m2["loss"])])
        bit &= same(m1["loss"], m2["loss"])
    pr, ps = param_dict(ref), param_dict(sh)
    perr = max(err(full(ps[n]), pr[n]) for n in pr)
    merr = max(max(err(full(o_sh.m[n]).float(), o_ref.m[n].float()),
                   err(full(o_sh.v[n]).float(), o_ref.v[n].float()))
               for n in pr)
    bit &= all(same(full(ps[n]), pr[n]) and same(full(o_sh.m[n]), o_ref.m[n])
               and same(full(o_sh.v[n]), o_ref.v[n]) for n in pr)
    return dict(losses=losses, perr=perr, merr=merr, bit=bool(bit)), sh


def trainer_resume(cfg, mesh, fam):
    # the Trainer on the sharded step: 3 steps straight, against 2 steps,
    # a checkpoint (DTensor leaves) and a resume into other parameters
    from repro_torch.train import DataConfig, SyntheticLM, Trainer, \
        TrainerConfig
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=8), device="cpu")
    opt = AdamWConfig(lr=LR)
    step = make_train_step(cfg, mesh, opt=opt)(data.batch_at(0))

    def trainer(params):
        distribute(params, mesh)
        return Trainer(cfg, data, step, params, adamw_init(params, opt),
                       TrainerConfig(total_steps=3, ckpt_every=2,
                                     ckpt_dir=os.path.join(TMP, "trainer"),
                                     log_every=0))
    a = trainer(load(fam)[1])
    a.run()
    b = trainer(model_class(cfg)(cfg, device="cpu"))     # not drawn
    resumed = b.try_resume() and b.step == 2
    b.run(1)
    pa, pb = param_dict(a.params), param_dict(b.params)
    return bool(resumed and all(same(full(pa[n]), full(pb[n])) for n in pa)
                and a.metrics_log[-1]["loss"] == b.metrics_log[-1]["loss"])


@torch.no_grad()
def decode(cfg, mesh, fam, tokens):
    # three decode steps, the cache sharded by cache_specs (fp32), against
    # the unsharded model: the logits' and the caches' largest error, over
    # their largest entry
    _, ref, _ = load(fam)
    _, sh, _ = load(fam)
    distribute(sh, mesh)
    b = tokens.shape[0]
    c_ref = init_cache(cfg, b, 16, dtype=torch.float32, device="cpu")
    c_sh = distribute_tree(
        init_cache(cfg, b, 16, dtype=torch.float32, device="cpu"),
        named_shardings(cache_specs(c_ref, mesh, batch=b), mesh))
    tok_sh = named_shardings(("data",), mesh)
    lerr = 0.0
    for t in range(3):
        l_ref, c_ref = decode_step(ref, cfg, c_ref, tokens[:, t], t)
        with sharding_hints(mesh), implicit_replication():
            l_sh, c_sh = decode_step(sh, cfg, c_sh,
                                     loop._shard(tokens[:, t], tok_sh), t)
        lerr = max(lerr, err(full(l_sh), l_ref) / float(l_ref.abs().max()))
    a, b_ = [], []
    _map_named(c_ref, lambda n, x: a.append(x))
    _map_named(c_sh, lambda n, x: b_.append(full(x)))
    cerr = max(err(y, x) / max(float(x.abs().max()), 1e-30)
               for x, y in zip(a, b_))
    return dict(lerr=lerr, cerr=cerr)


out = {}
for shape in job["meshes"]:
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    key = "x".join(map(str, shape))
    for fam in job["fams"]:
        cfg, ref, batch = load(fam)
        _, sh, _ = load(fam)
        distribute(sh, mesh)
        row = {}
        # gradients of one sharded forward/backward against the unsharded
        l_ref, g_ref = loop.loss_and_grads(ref, cfg, batch)
        b_sh = named_shardings(batch_specs(batch, mesh), mesh)
        sb = {k: loop._shard(x, b_sh[k]) for k, x in batch.items()}
        with sharding_hints(mesh), implicit_replication():
            l_sh, g_sh = loop.loss_and_grads(sh, cfg, sb)
        scale = max(float(g.abs().max()) for g in g_ref.values())
        row["gerr"] = max(float(((full(g_sh[n]) - g).abs()
                                 - 1e-4 * g.abs()).max()) for n, g in
                          g_ref.items()) / scale
        row["grad_placed"] = all(
            g_sh[n].placements == p.placements
            for n, p in param_dict(sh).items())
        row["lerr"] = abs(float(l_sh) - float(l_ref)) / abs(float(l_ref))
        opt = AdamWConfig() if world == 1 else AdamWConfig(
            lr=LR, eps=1.0, state_dtype="float32")
        r, sh = steps(cfg, ref, sh, mesh, batch, opt, 1)
        row.update(r)
        if fam == job["mb_fam"]:
            # twice the batch in 2 microbatches: each microbatch has the
            # shapes DTensor has already propagated
            big = {k: torch.cat([x, x.flip(0)]) for k, x in batch.items()}
            _, ref2, _ = load(fam)
            _, sh2, _ = load(fam)
            row["mb2"], _ = steps(cfg, ref2, distribute(sh2, mesh), mesh,
                                  big, opt, 2)
            per = batch["tokens"].shape[0] // (shape[0])
            try:
                make_train_step(cfg, mesh, microbatches=per + 1)(batch)
                row["mb_raises"] = False
            except ValueError:
                row["mb_raises"] = True
        if fam == job.get("trainer_fam") and shape == job["meshes"][0]:
            row["trainer"] = trainer_resume(cfg, mesh, fam)
        if fam in job["decode_fams"] and shape == job["meshes"][0]:
            row["decode"] = decode(cfg, mesh, fam, batch["tokens"])
        if fam == job["ckpt_fam"] and shape == job["meshes"][0]:
            d = os.path.join(TMP, f"ckpt{world}")
            saved = {n: full(p) for n, p in param_dict(sh).items()}
            ckpt.save(d, 2, param_dict(sh), {"arch": cfg.name})
            res = {}
            for name, tgt in job["remesh"].items():
                mesh_b = make_mesh(tgt, ("data", "model"), device_type="cpu")
                want = named_shardings(param_specs(saved, mesh_b), mesh_b)
                if name == "elastic":
                    tree, meta = elastic_restore(d, param_dict(sh), mesh_b)
                else:
                    tree, meta = ckpt.restore(d, saved, shardings=want)
                res[name] = all(
                    same(tree[n].full_tensor(), saved[n])
                    and tree[n].placements == want[n].placements
                    and tree[n].device_mesh is mesh_b for n in saved) \
                    and meta == {"arch": cfg.name}
            tree, _ = ckpt.restore(d, saved)
            res["unsharded"] = all(same(tree[n], saved[n]) and
                                   not hasattr(tree[n], "placements")
                                   for n in saved)
            row["ckpt"] = res
        out[f"{key}/{fam}"] = row
dist.destroy_process_group()
if rank == 0:
    print(json.dumps(out))
"""

JOBS = {4: dict(meshes=[[2, 2], [4, 1]], fams=[*FAMILIES, *VARIANTS],
                mb_fam="dense", ckpt_fam="dense",
                decode_fams=["dense", "hybrid"],
                remesh={"elastic": [1, 4], "shardings": [2, 2]}),
        1: dict(meshes=[[1, 1]], fams=list(FAMILIES), mb_fam="dense",
                ckpt_fam="dense", decode_fams=[], trainer_fam="dense",
                remesh={"elastic": [1, 1], "shardings": [1, 1]})}


def _start(world, tmp, job=None):
    env = dict(os.environ, PYTHONPATH=SRC, WORLD_SIZE=str(world),
               PG_INIT=f"file://{tmp}/pg{world}", TMP=str(tmp),
               LR=repr(LR), JOB=json.dumps(job or JOBS[world]))
    env.pop("JAX_PLATFORMS", None)
    return [subprocess.Popen([sys.executable, "-c", _RANK],
                             env=dict(env, RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for r in range(world)]


def _finish(procs):
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


def _ref_losses(cfg, params, batch):
    """Two steps of the reference's unsharded ``make_train_step``."""
    import jax
    import jax.numpy as jnp
    from repro.train import loop as RLoop
    from repro.train import optim as RO
    rc = _ref_cfg(cfg)
    rp = jax.tree_util.tree_map(jnp.asarray,
                                convert.lm_params_from_torch(params, cfg))
    opt = RO.AdamWConfig(lr=LR, eps=1.0, state_dtype="float32")
    step = RLoop.make_train_step(
        rc, opt=opt, schedule=lambda s: jnp.asarray(LR, jnp.float32),
        donate=False)
    rb = {k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64
                         else v.numpy()) for k, v in batch.items()}
    o = RO.adamw_init(rp, opt)
    losses = []
    for s in range(2):
        rp, o, m = step(rp, o, rb, jnp.asarray(s, jnp.int32))
        losses.append(float(m["loss"]))
    return losses


def _setups(tmp):
    """Each family's and variant's config, parameters and batch, drawn
    here and saved in ``tmp`` for the ranks to load."""
    setups = {}
    cells = {fam: (arch, {}, B) for fam, arch in FAMILIES.items()}
    cells.update({name: (FAMILIES[fam], kw, b)
                  for name, (fam, kw, b) in VARIANTS.items()})
    for i, (fam, (arch, kw, b)) in enumerate(cells.items()):
        cfg = dataclasses.replace(_tiny(arch), **kw)
        params = {n: p.detach().clone() for n, p in init_params(
            cfg, torch.Generator().manual_seed(i), device="cpu")
            .named_parameters()}
        batch = _batch(cfg, 100 + i, b)
        torch.save({"cfg": cfg, "params": params, "batch": batch},
                   tmp / f"{fam}.pt")
        setups[fam] = (cfg, params, batch)
    return setups


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("mesh")
    setups = _setups(tmp)
    procs = {w: _start(w, tmp) for w in JOBS}
    ref = {fam: _ref_losses(*setups[fam]) for fam in setups}
    return {w: _finish(p) for w, p in procs.items()}, ref


CELLS = [(m, f) for m in ("2x2", "4x1") for f in [*FAMILIES, *VARIANTS]]


@pytest.mark.parametrize("mesh,fam", CELLS)
def test_sharded_gradients_match_unsharded(runs, mesh, fam):
    row = runs[0][4][f"{mesh}/{fam}"]
    assert row["gerr"] <= 1e-5, row
    assert row["lerr"] <= 1e-5, row
    assert row["grad_placed"]           # each grad laid out as its param


@pytest.mark.parametrize("mesh,fam", CELLS)
def test_two_sharded_steps_match_unsharded(runs, mesh, fam):
    row = runs[0][4][f"{mesh}/{fam}"]
    for unsharded, sharded in row["losses"]:
        assert abs(sharded - unsharded) <= 1e-5 * abs(unsharded), row
    assert row["perr"] <= 1e-6 and row["merr"] <= 1e-6, row


@pytest.mark.parametrize("mesh,fam", CELLS)
def test_two_sharded_steps_match_reference(runs, mesh, fam):
    """The reference's unsharded step on the same parameters and batch."""
    row, want = runs[0][4][f"{mesh}/{fam}"], runs[1][fam]
    for (_, sharded), ref in zip(row["losses"], want):
        assert abs(sharded - ref) <= 1e-4 * abs(ref), (row, want)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_world_size_1_is_bit_for_bit(runs, fam):
    row = runs[0][1][f"1x1/{fam}"]
    assert row["bit"], row
    assert row["gerr"] <= 0 and row["lerr"] == 0, row


def test_world_size_1_microbatches_bit_for_bit(runs):
    assert runs[0][1]["1x1/dense"]["mb2"]["bit"]


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_microbatches_match_unsharded(runs, mesh):
    row = runs[0][4][f"{mesh}/dense"]["mb2"]
    for unsharded, sharded in row["losses"]:
        assert abs(sharded - unsharded) <= 1e-5 * abs(unsharded), row
    assert row["perr"] <= 1e-6 and row["merr"] <= 1e-6, row


@pytest.mark.parametrize("mesh", ["2x2", "4x1", "1x1"])
def test_microbatches_must_divide_the_shard(runs, mesh):
    world = 1 if mesh == "1x1" else 4
    assert runs[0][world][f"{mesh}/dense"]["mb_raises"]


@pytest.mark.parametrize("world,how", [(4, "elastic"), (4, "shardings"),
                                       (4, "unsharded"), (1, "elastic"),
                                       (1, "shardings"), (1, "unsharded")])
def test_checkpoint_across_meshes_bit_for_bit(runs, world, how):
    mesh = "2x2" if world == 4 else "1x1"
    assert runs[0][world][f"{mesh}/dense"]["ckpt"][how]


@pytest.mark.parametrize("fam", ["dense", "hybrid"])
def test_sharded_decode_matches_unsharded(runs, fam):
    row = runs[0][4][f"2x2/{fam}"]["decode"]
    assert row["lerr"] <= 1e-5 and row["cerr"] <= 1e-5, row


def test_trainer_resumes_a_sharded_run_bit_for_bit(runs):
    assert runs[0][1]["1x1/dense"]["trainer"]


def _within(world, row):
    """Whether a rank job's row meets this file's tolerances (the tests
    above, less the reference's losses)."""
    if world == 1:
        mb = row.get("mb2", {"bit": True})["bit"]
        return (row["bit"] and row["gerr"] <= 0 and row["lerr"] == 0
                and mb and row.get("trainer", True))
    steps = [row] + ([row["mb2"]] if "mb2" in row else [])
    return (row["gerr"] <= 1e-5 and row["lerr"] <= 1e-5
            and row["grad_placed"] and row.get("mb_raises", True)
            and all(abs(b - a) <= 1e-5 * abs(a) and r["perr"] <= 1e-6
                    and r["merr"] <= 1e-6
                    for r in steps for a, b in r["losses"])
            and all(row.get("ckpt", {}).values())
            and all(v <= 1e-5 for v in row.get("decode", {}).values()))


def main() -> int:
    """The rank jobs alone, without the reference (no JAX), one launch a
    family or variant so that one failure hides no other: for a torch
    other than the tests', e.g. the card's host (``PYTHONPATH=src python
    tests/test_torch_mesh_train.py``).  Prints each row and returns 1 if
    one fails or falls outside the tolerances."""
    import tempfile
    torch.set_num_threads(1)
    tmp = Path(tempfile.mkdtemp())
    bad = 0
    for fam in _setups(tmp):
        procs = {}
        for w, job in JOBS.items():
            if w == 4 or fam in FAMILIES:       # variants run on 4 ranks
                sub = tmp / f"{fam}{w}"
                sub.mkdir()
                (sub / f"{fam}.pt").symlink_to(tmp / f"{fam}.pt")
                procs[w] = _start(w, sub, dict(job, fams=[fam]))
        for w, p in procs.items():
            try:
                rows = _finish(p)
            except AssertionError as e:
                print(f"FAIL world {w} {fam}: {str(e)[-1500:]}", flush=True)
                bad += 1
                continue
            for key, row in rows.items():
                ok = _within(w, row)
                bad += not ok
                print("ok  " if ok else "OUT ", w, key, json.dumps(row),
                      flush=True)
    print(f"torch {torch.__version__}: {bad} failing", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
