"""The port's training stack (``repro_torch.train``, ``launch/train.py``)
against the JAX package's, on the CPU, with the same numpy inputs and the
reference's own parameters (carried across by ``repro_torch.convert``).

* AdamW: bf16 moments bit for bit with the reference's over three steps
  (both round fp32 to bf16 to nearest even, and the moments' arithmetic
  is the same sequence of fp32 products and sums), parameters within
  rtol 1e-6 (the bias correction's fp32 ``pow`` may differ by an ulp);
  clipping, weight decay on ``ndim >= 2`` only (by the reference's leaf
  shapes: its stacked layers' norm gains decay), ``cosine_schedule``;
* one train step against the reference's on a small dense config at fp32:
  loss within rel 1e-5, parameters within atol 1e-4 (4 % of the step's
  lr·|δ| ≤ 2.5e-3: where |g| is near eps = 1e-8, Adam's first step
  g/(|g| + eps) magnifies the gradient's rounding); remat changes no bit;
  k microbatches give the full batch's step (the reference test's
  rtol 2e-4, atol 2e-5);
* ``SyntheticLM``: a pure function of (seed, step), shifted labels, the
  Markov band;
* ``Trainer``: the loss decreases, and a resume from a checkpoint
  continues bit for bit (the reference's ``test_train.py`` case);
* ``launch/train.py --device cpu`` for both optimizers.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

from repro.models import init_params as ref_init_params
from repro.models.config import ModelConfig as RefConfig
from repro.train import loop as RLoop
from repro.train import optim as RO

from repro_torch import convert
from repro_torch.launch import train as launch
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM, Trainer,
                               TrainerConfig, adamw_init, adamw_update,
                               cosine_schedule, make_train_step)
from repro_torch.train import optim as O

_TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, dtype="float32",
             remat=False)
CFG, REF_CFG = ModelConfig(**_TINY), RefConfig(**_TINY)


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _bf16_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


# ------------------------------------------------------------------ AdamW
def test_adamw_matches_reference_bf16_moments_bitwise():
    params = {"b": _np(0, 8), "w": _np(1, 8, 8)}
    opt = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0,
               state_dtype="bfloat16")
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rs = RO.adamw_init(rp, RO.AdamWConfig(**opt))
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ps = adamw_init(pp, AdamWConfig(**opt))
    assert ps.m["w"].dtype == torch.bfloat16
    for step in range(3):
        # a global norm under grad_clip: the clip scale is exactly 1
        g = {"b": _np(10 + step, 8, scale=0.05),
             "w": _np(20 + step, 8, 8, scale=0.05)}
        rp, rs = RO.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                 rs, rp, RO.AdamWConfig(**opt),
                                 jnp.asarray(1e-2, jnp.float32))
        pp, ps = adamw_update({k: torch.from_numpy(v) for k, v in g.items()},
                              ps, pp, AdamWConfig(**opt),
                              torch.tensor(1e-2))
        assert int(ps.step) == int(rs.step) == step + 1
        for k in params:
            for mine, theirs in ((ps.m[k], rs.m[k]), (ps.v[k], rs.v[k])):
                np.testing.assert_array_equal(
                    _bf16_bits(mine), np.asarray(theirs).view(np.uint16))
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]),
                                       rtol=1e-6, atol=1e-7)


def test_adamw_matches_hand_computed_adam():
    """fp32-state AdamW step == Adam + decoupled decay by hand."""
    opt = AdamWConfig(state_dtype="float32", weight_decay=0.1,
                      grad_clip=0.0, b1=0.9, b2=0.999, eps=1e-8)
    w0, g = np.full((4, 4), 2.0, np.float32), np.full((4, 4), 0.5,
                                                      np.float32)
    params = {"w": torch.from_numpy(w0.copy())}
    p2, _ = adamw_update({"w": torch.from_numpy(g)}, adamw_init(params, opt),
                         params, opt, 1e-2)
    m = 0.1 * g / (1 - 0.9)
    v = 0.001 * g * g / (1 - 0.999)
    want = w0 - 1e-2 * (m / (np.sqrt(v) + 1e-8) + 0.1 * w0)
    np.testing.assert_allclose(p2["w"].numpy(), want, rtol=1e-5)


def test_grad_clip_matches_reference():
    g = {"a": _np(3, 10, scale=100.0), "b": _np(4, 3, 4, scale=100.0)}
    clipped, gn = O.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    r_clipped, r_gn = RO.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    assert float(gn) == pytest.approx(float(r_gn), rel=1e-6)
    for k in g:
        np.testing.assert_allclose(clipped[k].numpy(),
                                   np.asarray(r_clipped[k]), rtol=1e-6)
    assert float(O.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_weight_decay_on_matrices_only():
    opt = AdamWConfig(state_dtype="float32", weight_decay=1.0, grad_clip=0.0)
    params = {"b": torch.ones(8), "w": torch.ones(4, 4)}
    p2, _ = adamw_update({"b": torch.zeros(8), "w": torch.zeros(4, 4)},
                         adamw_init(params, opt), params, opt, 1e-2)
    np.testing.assert_array_equal(p2["b"].numpy(), 1.0)
    np.testing.assert_allclose(p2["w"].numpy(), 1.0 - 1e-2, rtol=1e-6)
    # an LM's per-layer gains are slices of a stacked [L, d] leaf in the
    # reference, which decays them; the final norm's gain is not
    assert O.decays("layers.3.ln1.g", torch.ones(8))
    assert not O.decays("ln_f.g", torch.ones(8))


@pytest.mark.parametrize("step", [0, 3, 10, 37, 60, 109, 110, 500])
def test_cosine_schedule_matches_reference(step):
    lr = cosine_schedule(1.0, warmup=10, total=110)(step)
    want = RO.cosine_schedule(1.0, 10, 110)(jnp.asarray(step, jnp.int32))
    assert lr.dtype == torch.float32
    assert float(lr) == pytest.approx(float(want), rel=1e-6, abs=1e-7)


# -------------------------------------------------------------- the step
def _batch(seed=0, b=8, s=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.zeros((b, 1), np.int32)], 1)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})


def _models(cfg=CFG):
    rparams = ref_init_params(REF_CFG, jax.random.PRNGKey(0))
    return rparams, convert.lm_params_to_torch(rparams, cfg, device="cpu")


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_train_step_matches_reference(state_dtype):
    opt = dict(lr=1e-2, state_dtype=state_dtype)
    rparams, model = _models()
    rb, pb = _batch()
    step = 50                          # in the default schedule's warmup
    rp, _, rm = RLoop.make_train_step(REF_CFG, opt=RO.AdamWConfig(**opt),
                                      donate=False)(
        rparams, RO.adamw_init(rparams, RO.AdamWConfig(**opt)), rb,
        jnp.asarray(step, jnp.int32))
    pstep = make_train_step(CFG, opt=AdamWConfig(**opt), device="cpu")
    model, ost, pm = pstep(model, adamw_init(model, AdamWConfig(**opt)), pb,
                           step)
    assert float(pm["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert int(ost.step) == 1
    got = convert.lm_params_from_torch(model, CFG)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(rp)[0]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0,
                                   err_msg=str(path))
    assert not any(p.requires_grad for p in model.parameters())


def test_remat_changes_no_bit(monkeypatch):
    """cfg.remat checkpoints every block while a gradient is taken, and
    the step's loss and parameters are the same bits as without it."""
    calls = []
    real = T.checkpoint
    monkeypatch.setattr(T, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, pb = _batch(1)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(CFG, remat=remat)
        _, model = _models(cfg)
        opt = AdamWConfig(lr=1e-2)
        model, _, m = make_train_step(cfg, opt=opt, device="cpu")(
            model, adamw_init(model, opt), pb, 50)
        out.append((float(m["loss"]), [p.clone() for p in
                                       model.parameters()]))
    assert len(calls) == CFG.n_layers           # one forward, remat only
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    # serving (no parameter requires a gradient) never checkpoints
    with torch.enable_grad():
        T.forward(model, dataclasses.replace(CFG, remat=True), pb["tokens"])
    assert len(calls) == CFG.n_layers


def test_microbatch_step_equals_full_batch():
    opt = AdamWConfig(lr=1e-2, state_dtype="float32")
    _, pb = _batch(2)
    out = []
    for k in (1, 4):
        _, model = _models()
        model, _, m = make_train_step(CFG, opt=opt, microbatches=k,
                                      device="cpu")(
            model, adamw_init(model, opt), pb, 50)
        out.append((float(m["loss"]), list(model.parameters())))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_mesh_waits_for_sharding():
    """``make_train_step(mesh=)`` no longer waits: it returns the
    reference's ``jit_for(batch_shape)`` (the sharded step itself is held
    in tests/test_torch_mesh_train.py), which refuses a microbatch count
    that does not divide the per-shard batch."""
    class Mesh:                   # what jit_for reads of a DeviceMesh
        mesh_dim_names, shape = ("data", "model"), (2, 1)

        def size(self, i):
            return self.shape[i]

    shapes = {"tokens": (4, 16), "labels": (4, 16)}      # 2 a data shard
    with pytest.raises(ValueError, match="per-shard"):
        make_train_step(CFG, mesh=Mesh(), microbatches=4)(shapes)
    assert callable(make_train_step(CFG, mesh=Mesh(), microbatches=2)(shapes))


# ------------------------------------------------------------------- data
def test_data_deterministic_per_step():
    cfg = DataConfig(vocab=64, seq_len=16, global_batch=4)
    d1, d2 = SyntheticLM(cfg, device="cpu"), SyntheticLM(cfg, device="cpu")
    assert torch.equal(d1.batch_at(7)["tokens"], d2.batch_at(7)["tokens"])
    assert not torch.equal(d1.batch_at(7)["tokens"], d1.batch_at(8)["tokens"])
    other = SyntheticLM(dataclasses.replace(cfg, seed=1), device="cpu")
    assert not torch.equal(d1.batch_at(7)["tokens"],
                           other.batch_at(7)["tokens"])
    assert d1.cursor(7) == {"seed": 0, "step": 7, "source": "markov"}


@pytest.mark.parametrize("source", ["markov", "uniform"])
def test_data_labels_shifted_and_in_range(source):
    d = SyntheticLM(DataConfig(vocab=64, seq_len=16, global_batch=3,
                               source=source), device="cpu")
    b = d.batch_at(0)
    assert b["tokens"].shape == (3, 16) and b["tokens"].dtype == torch.int64
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == 0).all()
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 64


def test_data_markov_band():
    d = SyntheticLM(DataConfig(vocab=1000, seq_len=64, global_batch=4,
                               source="markov", band=8), device="cpu")
    t = d.batch_at(0)["tokens"].numpy()
    diff = (t[:, 1:] - t[:, :-1]) % 1000
    diff = np.minimum(diff, 1000 - diff)
    assert diff.max() <= 8 and diff.max() > 0


def test_data_unknown_source():
    with pytest.raises(ValueError, match="unknown source"):
        SyntheticLM(DataConfig(vocab=8, seq_len=4, global_batch=1,
                               source="zipf"), device="cpu")


# ---------------------------------------------------------------- trainer
def test_trainer_loss_decreases_and_resume_bitwise(tmp_path):
    opt = AdamWConfig(lr=5e-3)                     # bf16 moments
    step = make_train_step(CFG, opt=opt, device="cpu")
    data = SyntheticLM(DataConfig(vocab=256, seq_len=32, global_batch=8),
                       device="cpu")

    def trainer(seed, **tc):
        model = T.init_params(CFG, torch.Generator().manual_seed(seed),
                              device="cpu")
        return Trainer(CFG, data, step, model, adamw_init(model, opt),
                       TrainerConfig(log_every=0, **tc),
                       torch.Generator().manual_seed(seed))

    tr = trainer(0, total_steps=12, ckpt_every=6, ckpt_dir=str(tmp_path))
    log = tr.run()
    assert log[-1]["loss"] < log[0]["loss"]
    ref_log = trainer(0, total_steps=18, ckpt_every=0,
                      ckpt_dir=str(tmp_path / "x")).run()
    # the same 12 steps again give the same bits
    assert [m["loss"] for m in log] == [m["loss"] for m in ref_log[:12]]

    tr2 = trainer(1, ckpt_dir=str(tmp_path))      # junk parameters
    assert tr2.try_resume() and tr2.step == 12
    assert int(tr2.opt_state.step) == 12
    assert torch.equal(tr2.generator.get_state(), tr.generator.get_state())
    for a, b in zip(tr2.params.parameters(), tr.params.parameters()):
        assert torch.equal(a, b)
    log2 = tr2.run(steps=6)
    for a, b in zip(log2, ref_log[12:]):
        assert a["loss"] == b["loss"], (a, b)


def test_trainer_without_checkpoint_does_not_resume(tmp_path):
    model = T.init_params(CFG, device="cpu")
    opt = AdamWConfig()
    tr = Trainer(CFG, None, make_train_step(CFG, opt=opt, device="cpu"),
                 model, adamw_init(model, opt),
                 TrainerConfig(ckpt_dir=str(tmp_path)))
    assert not tr.try_resume() and tr.step == 0


# ----------------------------------------------------------------- launch
@pytest.mark.parametrize("optimizer", ["adamw", "cggn"])
def test_launch_train_cpu(optimizer, tmp_path, capsys):
    log = launch.main(["--arch", "gemma3-1b", "--device", "cpu",
                       "--optimizer", optimizer, "--steps", "3",
                       "--seq-len", "32", "--batch", "4",
                       "--ckpt-dir", str(tmp_path)])
    assert len(log) == 3 and all(math.isfinite(m["loss"]) for m in log)
    assert "final loss" in capsys.readouterr().out
