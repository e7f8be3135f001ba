"""The MoE, SSM and hybrid families through the port's model API,
checkpoints and serving launcher, against the JAX package's, on the CPU at
fp32 and at the ``reduced()`` configs of granite-moe-1b-a400m,
llama4-scout-17b-a16e (top-1), mamba2-780m and zamba2-1.2b.  The
reference's own parameters are carried across by ``repro_torch.convert``;
the inputs are numpy, seeded.  Training is held in
``tests/test_torch_families_train.py``.

* ``forward_logits`` (and ``last_only``) and ``loss_fn``: logits within
  atol = rtol = 1e-4, the loss within rel 1e-5;
* ``decode_step`` over 5 steps at ragged positions from a converted
  reference cache: the logits at every step and the final caches (KV and
  SSM state) within 1e-4;
* checkpoints in the reference's layout: a reference LM tree saved by
  either package restores in the other bit for bit;
* at full width (laid out on the ``meta`` device), the port holds as many
  parameters as the reference's ``init_params``;
* ``launch.serve`` on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.train import checkpoint as ref_ckpt

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api, hybrid
from repro_torch.train import checkpoint as ckpt

KEY = jax.random.PRNGKey(0)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["granite-moe-1b-a400m", "llama4-scout-17b-a16e", "mamba2-780m",
         "zamba2-1.2b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many tiny ops: the suite runs
    several workers on the same cores, and busy-waiting thread pools slow
    tiny ops there by 50×.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or TOL))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


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


def test_reduced_configs_cover_the_families():
    kinds = {a: (c.family, c.moe and (c.moe.n_experts, c.moe.top_k),
                 c.attn_every) for a, c in
             ((a, get_config(a).reduced()) for a in ARCHS)}
    assert kinds == {"granite-moe-1b-a400m": ("moe", (8, 2), 0),
                     "llama4-scout-17b-a16e": ("moe", (8, 1), 0),
                     "mamba2-780m": ("ssm", None, 0),
                     "zamba2-1.2b": ("hybrid", None, 6)}
    assert isinstance(api.init_params(get_config("zamba2-1.2b").reduced(),
                                      torch.Generator(), device="meta"),
                      hybrid.Hybrid)


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_loss(models, arch):
    """S = 40: more than the reduced SSD chunk (32), so a padded tail
    chunk; 80 tokens route in one group."""
    rc, rp, pc, tp = _port(models, arch)
    tok, lab = _tokens(rc, (2, 40), 1), _tokens(rc, (2, 40), 2)
    want = ref_api.forward_logits(rp, rc, {"tokens": jnp.asarray(tok)})
    got = api.forward_logits(tp, pc, {"tokens": torch.from_numpy(tok)})
    _close(got, want)
    last = api.forward_logits(tp, pc, {"tokens": torch.from_numpy(tok)},
                              last_only=True)
    _close(last, np.asarray(want)[:, -1:])
    loss = api.loss_fn(tp, pc, {"tokens": torch.from_numpy(tok),
                                "labels": torch.from_numpy(lab)})
    ref_loss = ref_api.loss_fn(rp, rc, {"tokens": jnp.asarray(tok),
                                        "labels": jnp.asarray(lab)})
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step(models, arch):
    """5 steps at ragged positions (slot 1 two ahead) from a converted
    reference cache: logits at every step and the final caches agree."""
    rc, rp, pc, tp = _port(models, arch)
    ref_cache = ref_api.init_cache(rc, 2, 16, dtype=jnp.float32)
    cache = convert.lm_cache_to_torch(ref_cache, device="cpu")
    assert set(cache) == set(ref_cache)
    step = jax.jit(ref_api.decode_step, static_argnums=1)
    tok = _tokens(rc, (5, 2), 3)
    for t in range(5):
        pos = np.array([t, t + 2])
        logits, cache = api.decode_step(tp, pc, cache,
                                        torch.from_numpy(tok[t]),
                                        torch.from_numpy(pos))
        ref_logits, ref_cache = step(rp, rc, ref_cache, jnp.asarray(tok[t]),
                                     jnp.asarray(pos, jnp.int32))
        _close(logits, ref_logits)
    for name, c in cache.items():
        for f in dataclasses.fields(c):
            if isinstance(getattr(c, f.name), torch.Tensor):
                _close(getattr(c, f.name), getattr(ref_cache[name], f.name))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_counts_the_full_config(arch):
    """At full width, on the meta device: as many parameters as the
    reference's ``init_params`` (granite-moe 1,334,628,352; mamba2
    780,148,992; zamba2 1,104,937,856)."""
    model = api.init_params(get_config(arch), torch.Generator(),
                            device="meta")
    shapes = jax.eval_shape(lambda: ref_api.init_params(
        ref_get_config(arch), KEY))
    ref_n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        shapes))
    assert api.count_params(model) == ref_n
    assert ref_n == {"granite-moe-1b-a400m": 1_334_628_352,
                     "llama4-scout-17b-a16e": 100_695_577_600,
                     "mamba2-780m": 780_148_992,
                     "zamba2-1.2b": 1_104_937_856}[arch]


# ----------------------------------------------------------- checkpoints
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_roundtrip_reference_layout(models, arch, tmp_path):
    """A reference LM tree (stacked layers; zamba2's unstacked ``shared``)
    saved by the reference restores in the port (``lm_params_from_torch``'s
    tree as the template) bit for bit, and the port's save of it restores
    in the reference bit for bit."""
    rc, rp, pc, tp = _port(models, arch)
    ref_ckpt.save(str(tmp_path / "ref"), 3, {"params": rp})
    template = {"params": convert.lm_params_from_torch(
        api.init_params(pc, torch.Generator().manual_seed(1), device="cpu"),
        pc)}
    tree, _ = ckpt.restore(str(tmp_path / "ref"), template)
    restored = convert.lm_params_to_torch(
        {k: v.numpy() for k, v in convert._flatten(tree["params"])}, pc,
        device="cpu")
    for (n, a), (_, b) in zip(restored.named_parameters(),
                              tp.named_parameters()):
        assert torch.equal(a, b), n
    ckpt.save(str(tmp_path / "port"), 4,
              {"params": convert.lm_params_from_torch(tp, pc)})
    back, _ = ref_ckpt.restore(str(tmp_path / "port"), {"params": rp})
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path({"params": rp})[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))



# ------------------------------------------------------------- launcher
FAMILIES = ["granite-moe-1b-a400m", "mamba2-780m", "zamba2-1.2b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_serve_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--max-new", "4", "--max-len", "64"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
