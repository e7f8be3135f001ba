"""The port's LM modules (dense family) against the JAX package's, on the
CPU at fp32: the same numpy inputs and the reference's own parameters
(carried across by ``repro_torch.convert``) go through both.

* layers: ``rmsnorm``, ``layernorm``, RoPE, the SwiGLU and GELU MLPs, the
  tied embedding;
* ``attention()`` unchunked and Q-chunked (``CHUNKED_ABOVE``/``Q_CHUNK``
  patched on both packages' modules, as ``tests/test_models.py`` does),
  with GQA and a window; ``attn_decode`` on a full and on a ring cache, and
  with ragged per-slot positions;
* ``forward_logits`` (also chunked and ``last_only``) and ``decode_step``
  on the ``reduced()`` configs of gemma3-1b, h2o-danube-3-4b (uniform SWA)
  and qwen2.5-32b (full attention, ``qkv_bias``), plus gemma3-1b reduced
  to 6 layers: its plain reduction keeps 4 layers, all local, and the
  sixth is the first global one (the mixed local:global branch).

Tolerance: atol = rtol = 1e-4 (fp32; the two packages sum in other
orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

import repro.models.attention as RA
from repro.configs import cells as ref_cells
from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.models import api as ref_api
from repro.models import layers as RL
from repro.serve.kv_cache import bytes_per_slot as ref_bytes_per_slot

import repro_torch.models.attention as A
from repro_torch import convert
from repro_torch.configs import get_config, input_specs
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models.transformer import FULL_WINDOW, layer_windows
from repro_torch.serve.kv_cache import bytes_per_slot

KEY = jax.random.PRNGKey(0)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["gemma3-1b", "gemma3-1b-mixed", "h2o-danube-3-4b", "qwen2.5-32b"]


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or TOL))


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("d", [8, 32, 128])
def test_rmsnorm(d):
    g, x = _x((d,), 1), _x((4, 3, d), 2)
    got = L.rmsnorm(convert.load_tree(L.RMSNorm(d), {"g": g}),
                    torch.from_numpy(x), 1e-6)
    _close(got, RL.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x), 1e-6))


def test_layernorm():
    p = {"g": _x((32,), 1), "b": _x((32,), 2)}
    x = _x((4, 32), 3)
    got = L.layernorm(convert.load_tree(L.LayerNorm(32), p),
                      torch.from_numpy(x))
    want = RL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    _close(got, want)


@pytest.mark.parametrize("pos_shape", [(1, 12), (3, 1)])
def test_rope(pos_shape):
    pos = np.random.default_rng(4).integers(0, 5000, pos_shape)
    x = _x(pos_shape + (4, 32), 5)
    c, s = L.rope_freqs(torch.from_numpy(pos), 32, 1e6)
    rc, rs = RL.rope_freqs(jnp.asarray(pos), 32, 1e6)
    _close(c, rc)
    _close(L.apply_rope(torch.from_numpy(x), c, s),
           RL.apply_rope(jnp.asarray(x), rc, rs))


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp(kind):
    if kind == "swiglu":
        p, mod, fn = RL.init_mlp(KEY, 16, 64), L.MLP(16, 64), RL.mlp
    else:
        p, mod, fn = RL.init_mlp_gelu(KEY, 16, 64), L.MLPGelu(16, 64), \
            RL.mlp_gelu
    x = _x((2, 5, 16), 6)
    _close(L.ffn(convert.load_tree(mod, p), torch.from_numpy(x)),
           fn(p, jnp.asarray(x)))


def test_embed_unembed():
    p = RL.init_embedding(KEY, 64, 16)
    tp = convert.load_tree(L.Embedding(64, 16), p)
    tok = np.array([[3, 0, 63, 7]])
    h = L.embed(tp, torch.from_numpy(tok), torch.float32)
    _close(h, RL.embed(p, jnp.asarray(tok), jnp.float32))
    _close(L.unembed(tp, h), RL.unembed(p, RL.embed(p, jnp.asarray(tok),
                                                    jnp.float32)))


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("chunked", [False, True], ids=["full", "chunked"])
@pytest.mark.parametrize("kv,window", [(2, None), (2, 20), (1, 20)],
                         ids=["gqa", "gqa-window", "mqa-window"])
def test_attention(monkeypatch, kv, window, chunked):
    if chunked:        # both packages take their Q-chunked path
        for mod in (A, RA):
            monkeypatch.setattr(mod, "CHUNKED_ABOVE", 32)
            monkeypatch.setattr(mod, "Q_CHUNK", 16)
    p = RA.init_attention(KEY, 32, 4, kv, 8)
    tp = convert.load_tree(A.Attention(32, 4, kv, 8), p)
    x = _x((2, 64, 32), 7)
    kw = dict(n_heads=4, n_kv_heads=kv, head_dim=8, window=window)
    got = A.attention(tp, torch.from_numpy(x), **kw)
    _close(got, RA.attention(p, jnp.asarray(x), **kw))
    if chunked:        # and the chunks equal one pass (port alone)
        monkeypatch.setattr(A, "CHUNKED_ABOVE", 1 << 30)
        _close(got, A.attention(tp, torch.from_numpy(x), **kw).numpy(),
               atol=1e-5)


@pytest.mark.parametrize("ring", [False, True], ids=["full", "ring"])
def test_attn_decode(ring):
    """Token by token over T = 20 with window 8: a full cache with the
    window mask, or a ring of length 8 (wrapping twice)."""
    T, w = 20, 8
    p = RA.init_attention(KEY, 32, 4, 2, 8)
    tp = convert.load_tree(A.Attention(32, 4, 2, 8), p)
    x = _x((1, T, 32), 8)
    length = w if ring else T
    rc = RA.init_attn_cache(1, length, 2, 8, ring=ring, dtype=jnp.float32)
    tc = A.init_attn_cache(1, length, 2, 8, ring=ring, dtype=torch.float32)
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8, window=w)
    for t in range(T):
        y, tc = A.attn_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc, t,
                              **kw)
        ry, rc = RA.attn_decode(p, jnp.asarray(x[:, t:t + 1]), rc,
                                jnp.asarray(t), **kw)
        _close(y, ry)
    _close(tc.k, rc.k)
    _close(tc.v, rc.v)


def test_attn_decode_ragged_positions():
    """Per-slot positions over a cache with content: slots at 3 and 7."""
    p = RA.init_attention(KEY, 32, 4, 4, 8)
    tp = convert.load_tree(A.Attention(32, 4, 4, 8), p)
    x = _x((2, 1, 32), 9)
    k, v = _x((2, 4, 16, 8), 10), _x((2, 4, 16, 8), 11)
    rc = RA.AttnCache(jnp.asarray(k), jnp.asarray(v), False)
    tc = A.AttnCache(torch.from_numpy(k), torch.from_numpy(v), False)
    pos = np.array([3, 7])
    kw = dict(n_heads=4, n_kv_heads=4, head_dim=8)
    y, tc = A.attn_decode(tp, torch.from_numpy(x), tc, torch.from_numpy(pos),
                          **kw)
    ry, rc = RA.attn_decode(p, jnp.asarray(x), rc, jnp.asarray(pos), **kw)
    _close(y, ry)
    _close(tc.k, rc.k)


# ------------------------------------------------------------------- model
def _configs(arch):
    name = "gemma3-1b" if arch == "gemma3-1b-mixed" else arch
    rc, pc = ref_get_config(name).reduced(), get_config(name).reduced()
    if arch == "gemma3-1b-mixed":
        rc = dataclasses.replace(rc, n_layers=6)
        pc = dataclasses.replace(pc, n_layers=6)
    return rc, pc


@pytest.fixture(scope="module")
def models():
    """{arch: (ref cfg, ref params, port cfg, port model)}, built once."""
    out = {}
    for arch in ARCHS:
        rc, pc = _configs(arch)
        rp = ref_api.init_params(rc, KEY)
        out[arch] = (rc, rp, pc, convert.lm_params_to_torch(rp, pc,
                                                            device="cpu"))
    return out


def test_reduced_configs_cover_every_decode_branch():
    kinds = {}
    for arch in ARCHS:
        w = layer_windows(_configs(arch)[1])
        kinds[arch] = ("full" if w is None else "mixed" if FULL_WINDOW in w
                       else "swa")
    assert kinds == {"gemma3-1b": "swa", "gemma3-1b-mixed": "mixed",
                     "h2o-danube-3-4b": "swa", "qwen2.5-32b": "full"}
    assert _configs("qwen2.5-32b")[1].qkv_bias


def _tokens(cfg, shape, seed=12):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(models, arch):
    """S = 80 spans the reduced window (64)."""
    rc, rp, pc, tp = models[arch]
    tok = _tokens(rc, (2, 80))
    got = api.forward_logits(tp, pc, {"tokens": torch.from_numpy(tok)})
    want = ref_api.forward_logits(rp, rc, {"tokens": jnp.asarray(tok)})
    _close(got, want)
    last = api.forward_logits(tp, pc, {"tokens": torch.from_numpy(tok)},
                              last_only=True)
    _close(last, np.asarray(want)[:, -1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_chunked(models, monkeypatch, arch):
    for mod in (A, RA):
        monkeypatch.setattr(mod, "CHUNKED_ABOVE", 32)
        monkeypatch.setattr(mod, "Q_CHUNK", 16)
    rc, rp, pc, tp = models[arch]
    tok = _tokens(rc, (1, 80), seed=13)
    _close(api.forward_logits(tp, pc, {"tokens": torch.from_numpy(tok)}),
           ref_api.forward_logits(rp, rc, {"tokens": jnp.asarray(tok)}))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step(models, arch):
    """72 steps at ragged positions (slot 1 three ahead) from a converted
    reference cache: the ring (length 64) wraps; logits at every step and
    the final caches agree."""
    rc, rp, pc, tp = models[arch]
    ref_cache = ref_api.init_cache(rc, 2, 96, dtype=jnp.float32)
    cache = convert.lm_cache_to_torch(ref_cache, device="cpu")
    assert {n: c.ring for n, c in cache.items()} == \
        {n: c.ring for n, c in ref_cache.items()}
    step = jax.jit(ref_api.decode_step, static_argnums=1)
    tok = _tokens(rc, (72, 2), seed=14)
    for t in range(72):
        pos = np.array([t, t + 3])
        logits, cache = api.decode_step(tp, pc, cache,
                                        torch.from_numpy(tok[t]),
                                        torch.from_numpy(pos))
        ref_logits, ref_cache = step(rp, rc, ref_cache, jnp.asarray(tok[t]),
                                     jnp.asarray(pos, jnp.int32))
        _close(logits, ref_logits)
    for name, c in cache.items():
        _close(c.k, ref_cache[name].k)
        _close(c.v, ref_cache[name].v)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn(models, arch):
    rc, rp, pc, tp = models[arch]
    tok, lab = _tokens(rc, (2, 16), 15), _tokens(rc, (2, 16), 16)
    got = api.loss_fn(tp, pc, {"tokens": torch.from_numpy(tok),
                               "labels": torch.from_numpy(lab)})
    want = ref_api.loss_fn(rp, rc, {"tokens": jnp.asarray(tok),
                                    "labels": jnp.asarray(lab)})
    assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("arch", ["gemma3-1b", "h2o-danube-3-4b",
                                  "qwen2.5-32b"])
def test_init_params_counts_the_full_config(arch):
    """At full width, laid out on the meta device (nothing allocated): the
    port holds as many parameters as the reference's ``init_params``; for
    gemma3-1b that is the config's ``param_count()``, 999,812,736 (qwen's
    ``param_count()`` counts an untied unembedding that neither package
    allocates)."""
    cfg = get_config(arch)
    model = api.init_params(cfg, torch.Generator(), device="meta")
    shapes = jax.eval_shape(lambda: ref_api.init_params(
        ref_get_config(arch), KEY))
    ref_n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        shapes))
    assert api.count_params(model) == ref_n
    if arch == "gemma3-1b":
        assert ref_n == cfg.param_count() == 999_812_736


def test_init_params_draws_the_reference_distribution():
    """Truncated normal (±2σ) at scale d_in ** -0.5 for dense weights and
    1.0 for the embedding; norms are ones; the same generator seed gives
    the same parameters."""
    cfg = get_config("gemma3-1b").reduced()
    a = api.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = api.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    w = a.layers[0].mlp.wo.w                       # [d_ff, d]
    assert float(w.abs().max()) <= 2.0 * cfg.d_ff ** -0.5
    assert float(w.std()) == pytest.approx(0.88 * cfg.d_ff ** -0.5, rel=0.05)
    assert float(a.embed.e.abs().max()) <= 2.0
    assert torch.equal(a.layers[1].ln2.g, torch.ones(cfg.d_model))


@pytest.mark.parametrize("arch", ARCHS[:1] + ["h2o-danube-3-4b",
                                              "qwen2.5-32b", "whisper-base"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bytes_per_slot(arch, dtype):
    assert bytes_per_slot(get_config(arch), 1024, getattr(torch, dtype)) \
        == ref_bytes_per_slot(ref_get_config(arch), 1024,
                              getattr(jnp, dtype))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-780m",
                                  "zamba2-1.2b", "whisper-base"])
def test_unported_families_raise(arch):
    """The MoE, SSM, hybrid and encoder-decoder families raised here until
    they were ported (the test keeps its name); each now builds its
    module: ``Transformer``, ``Hybrid`` and, for whisper, ``EncDec``."""
    from repro_torch.models.encdec import EncDec
    cfg = get_config(arch).reduced()
    model = api.init_params(cfg, torch.Generator(), device="meta")
    assert isinstance(model, api.model_class(cfg))
    assert isinstance(model, EncDec) == (arch == "whisper-base")


@pytest.mark.parametrize("arch", ["granite-34b", "internvl2-76b"])
def test_forward_logits_other_dense_configs(arch):
    """The rest of the dense stack: granite's LayerNorm and GELU MLP, and
    the VLM's prefix of patch embeddings (logits over the tokens only)."""
    rc, pc = ref_get_config(arch).reduced(), get_config(arch).reduced()
    rp = ref_api.init_params(rc, KEY)
    tp = convert.lm_params_to_torch(rp, pc, device="cpu")
    tok = _tokens(rc, (2, 24), seed=17)
    batch = {"tokens": tok}
    if rc.n_patches:
        batch["patch_embeds"] = _x((2, rc.n_patches, rc.d_model), 18)
    got = api.forward_logits(tp, pc, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    want = ref_api.forward_logits(rp, rc, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    assert got.shape == (2, 24, rc.vocab)
    _close(got, want)


def test_lm_cache_to_torch_keeps_bf16_bits():
    """The reference's default cache dtype is bf16, which numpy holds as
    ``ml_dtypes``; the conversion carries its bits unchanged."""
    x = _x((2, 1, 3, 8, 4), 19)
    ref = {"ring": RA.AttnCache(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(-x, jnp.bfloat16), True)}
    got = convert.lm_cache_to_torch(ref, device="cpu")["ring"]
    assert got.k.dtype == torch.bfloat16 and got.ring
    np.testing.assert_array_equal(got.k.float().numpy(),
                                  np.asarray(ref["ring"].k, np.float32))
    np.testing.assert_array_equal(got.v.float().numpy(),
                                  np.asarray(ref["ring"].v, np.float32))


def _spec_leaves(tree, prefix=""):
    """``(path, shape, dtype name)`` of every leaf of an input spec: a
    cache dict's stacks by their tensor fields, a bare tensor as itself."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], f"{prefix}{k}.")
    elif hasattr(tree, "shape"):
        yield prefix[:-1], tuple(tree.shape), str(tree.dtype).split(".")[-1]
    else:
        for f in dataclasses.fields(tree):
            if hasattr(getattr(tree, f.name), "shape"):
                yield from _spec_leaves(getattr(tree, f.name),
                                        f"{prefix}{f.name}.")


@pytest.mark.parametrize("arch,shape,runs", [
    (a, s, ok) for a, s, ok, _ in ref_cells()])
def test_input_specs(arch, shape, runs):
    """Every (arch × shape) cell: ``meta`` tensors of the reference's
    shapes (tokens, labels and positions int64, torch's index dtype; the
    rest the reference's dtypes), nothing allocated; a skipped cell
    raises as the reference's does."""
    if not runs:
        with pytest.raises(ValueError, match="SKIP"):
            ref_input_specs(arch, shape)
        with pytest.raises(ValueError, match="SKIP"):
            input_specs(arch, shape)
        return
    want = list(_spec_leaves(ref_input_specs(arch, shape)))
    specs = input_specs(arch, shape)
    got = list(_spec_leaves(specs))
    ints = {"tokens", "labels", "token", "pos"}
    assert [(p, sh) for p, sh, _ in got] == [(p, sh) for p, sh, _ in want]
    for (p, _, dt), (_, _, dt_ref) in zip(got, want):
        assert dt == ("int64" if p in ints else dt_ref), p
    tensors = [specs[k] for k in specs if k != "cache"]
    if "cache" in specs:
        from repro_torch.serve.kv_cache import _leaves
        tensors += list(_leaves(specs["cache"]))
    assert all(t.device.type == "meta" for t in tensors)
