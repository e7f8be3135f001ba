"""Training the MoE, SSM and hybrid families through the port's trainer,
CGGN and launcher, against the JAX package's, on the CPU at fp32 and at
the ``reduced()`` configs of granite-moe-1b-a400m, llama4-scout-17b-a16e
(top-1), mamba2-780m and zamba2-1.2b (the reference's own parameters,
carried across by ``repro_torch.convert``; numpy inputs, seeded).

* one AdamW train step (``make_train_step``): the gradients within rtol
  1e-4 and atol 1e-5 of their largest entry, the loss within rel 1e-5,
  the parameters within atol 1e-4 (``tests/test_torch_train.py``'s
  tolerances for the dense family) where Adam's first step is well posed;
  remat changes no bit on the hybrid;
* one CGGN step through ``launch/train.cggn_lm_step`` on granite-moe and
  mamba2 with the reference's probe draws (``tests/test_torch_gn.py``'s
  tolerances: parameters atol 1e-4, metrics rel 1e-4);
* ``launch.train`` with both optimizers on the CPU.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.train import cggn as RC
from repro.train import loop as RLoop
from repro.train import optim as RO

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import gn as G
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import cggn_lm_step
from repro_torch.models import hybrid
from repro_torch.train import AdamWConfig, adamw_init, make_train_step
from repro_torch.train import cggn as C
from repro_torch.train.loop import loss_and_grads

KEY = jax.random.PRNGKey(0)
ARCHS = ["granite-moe-1b-a400m", "llama4-scout-17b-a16e", "mamba2-780m",
         "zamba2-1.2b"]
FAMILIES = ["granite-moe-1b-a400m", "mamba2-780m", "zamba2-1.2b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many tiny ops: the suite runs
    several workers on the same cores, and busy-waiting thread pools slow
    tiny ops there by 50×.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """{arch: (ref cfg, ref params, port cfg)}; the port's model is built
    per test (training updates it in place)."""
    out = {}
    for arch in ARCHS:
        rc, pc = ref_get_config(arch).reduced(), get_config(arch).reduced()
        out[arch] = (rc, ref_api.init_params(rc, KEY), pc)
    return out


def _port(models, arch):
    rc, rp, pc = models[arch]
    return rc, rp, pc, convert.lm_params_to_torch(rp, pc, device="cpu")


def _batch(cfg, seed, b=4, s=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.zeros((b, 1), np.int32)], 1)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()})


def _compare_trees(got, want):
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0,
                                   err_msg=str(path))


#: Adam's first step is g / (|g| + eps) ≈ sign(g), g the clipped gradient:
#: for |g| near eps = 1e-8 it turns a gradient's last-bit rounding into a
#: step of either sign; at |g| ≥ 1e-6 it is within 1 % of sign(g)
ADAM_WELL_POSED = 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step_matches_reference(models, arch):
    """One step with bf16 moments (the default) in the schedule's warmup.
    The gradients within rtol 1e-4 and 1e-5 of the gradient's largest entry
    (the packages sum the batch in other orders; top-1 routing's router
    gradient is 0 up to rounding); the parameters after the step within
    atol 1e-4 wherever the reference's clipped gradient is 0 (the step is
    weight decay alone) or at least ``ADAM_WELL_POSED``: 1.9–10.5 % of the
    entries fall between (granite-moe's reduced experts hold 19 of
    1,048,576 below 1e-7 before clipping, where the step magnifies a 1e-8
    rounding to 2.4e-4).  The stacked SSM scalars (``A_log``, ``D``,
    ``dt_bias``, ``conv_b``, ``norm.g``: [L, h] leaves in the reference)
    decay, as the reference's do."""
    rc, rp, pc, tp = _port(models, arch)
    opt = AdamWConfig(lr=1e-2)
    rb, pb = _batch(rc, 4)
    _, rg = jax.value_and_grad(lambda p: ref_api.loss_fn(p, rc, rb))(rp)
    rg = {k: np.asarray(v) for k, v in convert._flatten(rg)}
    scale = max(np.abs(g).max() for g in rg.values())
    _, g = loss_and_grads(tp, pc, pb)
    got_g = dict(convert._flatten(convert.lm_params_from_torch(g, pc)))
    for path, want in rg.items():
        np.testing.assert_allclose(got_g[path], want, rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=path)
    clip = min(1.0, opt.grad_clip / np.sqrt(sum(
        np.sum(np.square(g, dtype=np.float64)) for g in rg.values())))
    rparams, _, rm = RLoop.make_train_step(
        rc, opt=RO.AdamWConfig(lr=opt.lr), donate=False)(
        rp, RO.adamw_init(rp, RO.AdamWConfig(lr=opt.lr)), rb,
        jnp.asarray(50, jnp.int32))
    model, _, m = make_train_step(pc, opt=opt, device="cpu")(
        tp, adamw_init(tp, opt), pb, 50)
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    got = dict(convert._flatten(convert.lm_params_from_torch(model, pc)))
    for path, want in convert._flatten(rparams):
        well = (np.abs(rg[path]) * clip >= ADAM_WELL_POSED) \
            | (rg[path] == 0)
        np.testing.assert_allclose(got[path][well], np.asarray(want)[well],
                                   atol=1e-4, rtol=0, err_msg=path)


def test_hybrid_remat_changes_no_bit(models, monkeypatch):
    """``cfg.remat`` checkpoints each SSD layer (not the shared block) while
    a gradient is taken; the step's loss and parameters are the same bits
    as without it."""
    calls = []
    real = hybrid.checkpoint
    monkeypatch.setattr(hybrid, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rc, rp, pc = models["zamba2-1.2b"]
    _, pb = _batch(rc, 5, b=2, s=16)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(pc, remat=remat)
        tp = convert.lm_params_to_torch(rp, cfg, device="cpu")
        opt = AdamWConfig(lr=1e-2)
        tp, _, m = make_train_step(cfg, opt=opt, device="cpu")(
            tp, adamw_init(tp, opt), pb, 50)
        out.append((float(m["loss"]), [p.clone() for p in tp.parameters()]))
    assert len(calls) == pc.n_layers
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def _ref_draws(key, n, probes):
    _, sub = jax.random.split(key)
    return [np.asarray(jax.random.rademacher(k, (n,), dtype=jnp.float32))
            for k in jax.random.split(sub, probes)]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-780m"])
def test_cggn_step_matches_reference(models, arch, monkeypatch):
    """The launcher's settings (cg_iters 8, ``tpu_fp32``, 4 probes), the
    reference's probe draws reordered as the port's flat vector."""
    rc, rp, pc, tp = _port(models, arch)
    rb, pb = _batch(rc, 6, b=2, s=16)
    ccfg = dict(cg_iters=8, scheme="tpu_fp32", lr=1.0)
    labels = rb["labels"]

    def ref_logits(p):
        return ref_api.forward_logits(p, rc, {"tokens": rb["tokens"]})

    def ref_loss(lg):
        lse = jax.nn.logsumexp(lg, axis=-1)
        return jnp.mean(lse - jnp.take_along_axis(
            lg, labels[..., None], axis=-1)[..., 0])

    key = jax.random.PRNGKey(0)
    st = RC.cggn_init(rp, key)
    p_r, _, m_r = RC.cggn_update(
        rp, st, loss_logits_fn=ref_loss, logits_fn=ref_logits,
        loss_value_and_grad=lambda p: jax.value_and_grad(
            lambda q: ref_loss(ref_logits(q)))(p),
        cfg=RC.CGGNConfig(**ccfg))
    draws = iter([convert.lm_flat_to_torch(d, pc, device="cpu") for d in
                  _ref_draws(key, int(st.diag.shape[0]), 4)])
    monkeypatch.setattr(G, "_rademacher",
                        lambda n, gen, dtype: next(draws).to(dtype))
    st_p = convert.cggn_state_to_torch(st, pc, device="cpu")
    model, st_p, m_p = cggn_lm_step(tp, st_p, pb, C.CGGNConfig(**ccfg))
    _compare_trees(convert.lm_params_from_torch(model, pc), p_r)
    for k in ("loss", "delta_norm", "grad_norm"):
        assert float(m_p[k]) == pytest.approx(float(m_r[k]), rel=1e-4)
    assert 1 <= m_p["cg_iters"] <= 8 and st_p.step == 1



# ----------------------------------------------------------------- launch
@pytest.mark.parametrize("optimizer", ["adamw", "cggn"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_train_cpu(arch, optimizer, tmp_path):
    log = launch_train.main(["--arch", arch, "--device", "cpu",
                             "--optimizer", optimizer, "--steps", "2",
                             "--seq-len", "16", "--batch", "2",
                             "--ckpt-dir", str(tmp_path)])
    assert len(log) == 2 and all(math.isfinite(m["loss"]) for m in log)
