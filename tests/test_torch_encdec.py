"""The encoder-decoder family (whisper-base's backbone) through the port's
model API, engine, trainer, CGGN, checkpoints, conversions and launchers,
against the JAX package's, on the CPU at fp32 and at whisper-base's
``reduced()`` config (2 encoder layers over 64 frames, 4 decoder layers,
d 128).  The reference's own parameters are carried across by
``repro_torch.convert``; tokens and frame embeddings are numpy, seeded.

Tolerances (fp32; the packages sum in other orders):
* ``encode``, ``forward`` (full, ``last_only`` and Q-chunked),
  ``prefill_cross``, 8 ``decode_step``s and the caches: max |Δ| ≤ 1e-5 of
  the reference's largest magnitude; ``loss_fn`` rel 1e-5; the gradients
  rtol 1e-4 and atol 1e-5 of the largest entry (as the other families'
  training tests);
* the port's own teacher-forced forward against its decode: 1e-4;
* the engine's greedy tokens equal the reference engine's;
* one AdamW step and one CGGN step with audio: the other families'
  tolerances (parameters atol 1e-4, metrics rel 1e-4).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import numpy as np
import pytest
import torch

import repro.models.attention as RA
from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.models import encdec as ref_encdec
from repro.serve import DecodeEngine as RefEngine
from repro.serve import EngineConfig as RefConfig
from repro.train import cggn as RC
from repro.train import checkpoint as ref_ckpt
from repro.train import loop as RLoop
from repro.train import optim as RO

import repro_torch.models.attention as A
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import gn as G
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import cggn_lm_step, lm_ggn_fns
from repro_torch.models import api, encdec
from repro_torch.serve import DecodeEngine, EngineConfig
from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM, Trainer,
                               TrainerConfig, adamw_init, make_train_step)
from repro_torch.train import cggn as C
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import loss_and_grads
from repro_torch.train.optim import decays

KEY = jax.random.PRNGKey(0)
ARCH = "whisper-base"
REL = 1e-5
#: Adam's first step magnifies a gradient's rounding near eps (see
#: tests/test_torch_families_train.py): parameters are held where the
#: reference's clipped gradient is 0 or at least this
ADAM_WELL_POSED = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many tiny ops (the suite runs
    several workers on the same cores).  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    rc = ref_get_config(ARCH).reduced()
    return rc, ref_api.init_params(rc, KEY)


def _port(ref):
    rc, rp = ref
    pc = get_config(ARCH).reduced()
    return rc, rp, pc, convert.lm_params_to_torch(rp, pc, device="cpu")


def _close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _audio(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)


def _batches(cfg, b, s, seed):
    """(reference batch, port batch): tokens, next-token labels, audio."""
    toks = _tokens(cfg, (b, s), seed).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.zeros((b, 1), np.int32)], 1)
    audio = _audio(cfg, b, seed + 1)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             "audio_embeds": jnp.asarray(audio)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long(),
             "audio_embeds": torch.from_numpy(audio)})


# ------------------------------------------------------------- the model
def test_reduced_config_and_module(ref):
    rc, rp, pc, tp = _port(ref)
    assert (pc.encoder.n_layers, pc.encoder.n_ctx, pc.n_layers) == (2, 64, 4)
    assert isinstance(tp, encdec.EncDec) and api.model_class(pc) is \
        encdec.EncDec
    assert [n for n, _ in tp.named_children()] == \
        ["embed", "enc_layers", "enc_ln", "dec_layers", "ln_f"]
    # every attention has q/k/v biases, whatever cfg.qkv_bias says
    for lp in list(tp.enc_layers) + list(tp.dec_layers):
        for attn in [lp.attn] + ([lp.xattn] if hasattr(lp, "xattn") else []):
            assert all(d.b is not None for d in (attn.wq, attn.wk, attn.wv))
            assert attn.wo.b is None


def test_sinusoids_match_reference():
    """fp32 throughout: the packages' exp and sin differ by an ulp, which
    moves an angle of up to ``length`` radians by one of its ulps; the
    values agree within two ulps of the largest angle."""
    for length, d in ((64, 128), (1500, 512)):
        got = encdec._sinusoids(length, d)
        assert got.dtype == torch.float32 and got.shape == (length, d)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref_encdec._sinusoids(length, d)),
            atol=2 * float(np.spacing(np.float32(length))), rtol=0)


def test_encode(ref):
    rc, rp, pc, tp = _port(ref)
    audio = _audio(rc, 2, 1)
    _close(encdec.encode(tp, pc, torch.from_numpy(audio)),
           ref_encdec.encode(rp, rc, jnp.asarray(audio)))


@pytest.mark.parametrize("chunked", [False, True], ids=["full", "chunked"])
def test_forward_logits(ref, monkeypatch, chunked):
    """Full and ``last_only``; chunked: the decoder's self and cross
    attention run query chunk by query chunk (``CHUNKED_ABOVE`` and
    ``Q_CHUNK`` patched on both packages) — the encoder's 64 frames too."""
    if chunked:
        for mod in (A, RA):
            monkeypatch.setattr(mod, "CHUNKED_ABOVE", 32)
            monkeypatch.setattr(mod, "Q_CHUNK", 16)
    rc, rp, pc, tp = _port(ref)
    rb, pb = _batches(rc, 2, 40, 2)
    want = ref_api.forward_logits(rp, rc, rb)
    _close(api.forward_logits(tp, pc, pb), want)
    _close(api.forward_logits(tp, pc, pb, last_only=True),
           np.asarray(want)[:, -1:])


def test_cross_attention_matches_reference(ref):
    """``attention(cross_kv=)`` alone, S 24 queries against T 64 states: no
    mask and no RoPE, whatever ``causal``, ``window`` and ``positions``
    say."""
    rc, rp, pc, tp = _port(ref)
    x, kv = _audio(rc, 2, 3)[:, :24], _audio(rc, 2, 4)
    kw = dict(n_heads=pc.n_heads, n_kv_heads=pc.n_kv_heads, head_dim=pc.hd)
    lp = jax.tree_util.tree_map(lambda a: a[1], rp["dec_layers"])["xattn"]
    want = RA.attention(lp, jnp.asarray(x), cross_kv=jnp.asarray(kv), **kw)
    got = A.attention(tp.dec_layers[1].xattn, torch.from_numpy(x),
                      cross_kv=torch.from_numpy(kv), causal=True, window=4,
                      positions=torch.arange(24)[None] + 7, **kw)
    _close(got, want)


def test_grouped_helpers_match_reference():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    w = rng.standard_normal((2, 8, 3, 20)).astype(np.float32)
    _close(A._gqa_scores_grouped(torch.from_numpy(q), torch.from_numpy(k)),
           RA._gqa_scores_grouped(jnp.asarray(q), jnp.asarray(k)))
    _close(A._gqa_out_grouped(torch.from_numpy(w), torch.from_numpy(k)),
           RA._gqa_out_grouped(jnp.asarray(w), jnp.asarray(k)))


def test_loss_and_gradients(ref):
    rc, rp, pc, tp = _port(ref)
    rb, pb = _batches(rc, 2, 16, 6)
    loss_r, g_r = jax.value_and_grad(lambda p: ref_api.loss_fn(p, rc, rb))(
        rp)
    assert float(api.loss_fn(tp, pc, pb)) == pytest.approx(float(loss_r),
                                                           rel=1e-5)
    loss, g = loss_and_grads(tp, pc, pb)
    assert float(loss) == pytest.approx(float(loss_r), rel=1e-5)
    got = dict(convert._flatten(convert.lm_params_from_torch(g, pc)))
    want = {k: np.asarray(v) for k, v in convert._flatten(g_r)}
    assert set(got) == set(want)
    scale = max(np.abs(v).max() for v in want.values())
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=path)


def test_remat_changes_no_bit(ref, monkeypatch):
    """``cfg.remat`` checkpoints every encoder and decoder layer while a
    gradient is taken; the loss and gradients are the same bits."""
    calls = []
    real = encdec.checkpoint
    monkeypatch.setattr(encdec, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rc, rp, pc, _ = _port(ref)
    _, pb = _batches(rc, 2, 12, 7)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(pc, remat=remat)
        tp = convert.lm_params_to_torch(rp, cfg, device="cpu")
        out.append(loss_and_grads(tp, cfg, pb))
    assert len(calls) == pc.encoder.n_layers + pc.n_layers
    assert torch.equal(out[0][0], out[1][0])
    for n in out[0][1]:
        assert torch.equal(out[0][1][n], out[1][1][n]), n


# ------------------------------------------------------------- decoding
def _ref_decode_cache(rc, rp, audio, max_len):
    cache = ref_api.init_cache(rc, audio.shape[0], max_len,
                               dtype=jnp.float32)
    ck, cv = ref_encdec.prefill_cross(
        rp, rc, ref_encdec.encode(rp, rc, jnp.asarray(audio)))
    return dict(cache, cross_k=ck, cross_v=cv)


def test_prefill_cross_and_decode_steps(ref):
    """``prefill_cross`` from the encoder states, then 8 ``decode_step``s
    at ragged positions (slot 1 two ahead) from a converted reference
    cache: logits at every step and the final caches agree."""
    rc, rp, pc, tp = _port(ref)
    audio = _audio(rc, 2, 8)
    enc_r = ref_encdec.encode(rp, rc, jnp.asarray(audio))
    ck_r, cv_r = ref_encdec.prefill_cross(rp, rc, enc_r)
    ck, cv = encdec.prefill_cross(tp, pc, encdec.encode(
        tp, pc, torch.from_numpy(audio)))
    assert ck.shape == (pc.n_layers, 2, pc.encoder.n_ctx, pc.n_kv_heads,
                        pc.hd)
    _close(ck, ck_r)
    _close(cv, cv_r)
    ref_cache = _ref_decode_cache(rc, rp, audio, 16)
    cache = convert.lm_cache_to_torch(ref_cache, device="cpu")
    assert isinstance(cache["cross_k"], torch.Tensor)
    step = jax.jit(ref_api.decode_step, static_argnums=1)
    tok = _tokens(rc, (8, 2), 9)
    for t in range(8):
        pos = np.array([t, t + 2])
        logits, cache = api.decode_step(tp, pc, cache,
                                        torch.from_numpy(tok[t]),
                                        torch.from_numpy(pos))
        ref_logits, ref_cache = step(rp, rc, ref_cache, jnp.asarray(tok[t]),
                                     jnp.asarray(pos, jnp.int32))
        _close(logits, ref_logits)
    _close(cache["self"].k, ref_cache["self"].k)
    _close(cache["self"].v, ref_cache["self"].v)
    np.testing.assert_array_equal(cache["cross_k"].numpy(),
                                  np.asarray(ref_cache["cross_k"]))


def test_forward_equals_decode(ref):
    """The port alone: 8 decode steps after ``prefill_cross`` give the
    teacher-forced forward's logits at every position, within 1e-4."""
    _, _, pc, tp = _port(ref)
    tok = torch.from_numpy(_tokens(pc, (2, 8), 10))
    audio = torch.from_numpy(_audio(pc, 2, 11))
    want = api.forward_logits(tp, pc, {"tokens": tok, "audio_embeds": audio})
    cache = api.init_cache(pc, 2, 8, torch.float32, device="cpu")
    ck, cv = encdec.prefill_cross(tp, pc, encdec.encode(tp, pc, audio))
    cache["cross_k"].copy_(ck)
    cache["cross_v"].copy_(cv)
    for t in range(8):
        logits, cache = api.decode_step(tp, pc, cache, tok[:, t], t)
        np.testing.assert_allclose(logits.numpy(), want[:, t].numpy(),
                                   atol=1e-4, rtol=1e-4)


def _engines(ref, **kw):
    rc, rp, pc, tp = _port(ref)
    kw = dict(cache_dtype="float32", **kw)
    return (RefEngine(rc, rp, RefConfig(**kw)),
            DecodeEngine(pc, tp, EngineConfig(device="cpu", **kw)))


def test_engine_greedy_matches_reference(ref):
    """Two requests, each with its own audio, on one slot (the second
    reuses it): the same greedy tokens as the reference engine's, and a
    reused slot's tokens equal a fresh engine's for the same request."""
    rc = ref[0]
    audio = [_audio(rc, 1, 12)[0], _audio(rc, 1, 13)[0]]
    prompts = [[5, 9, 17, 3], [44, 8]]
    outs = []
    for eng, wrap in zip(_engines(ref, batch_slots=1, max_len=32),
                         (jnp.asarray, torch.from_numpy)):
        got = []
        for prompt, a in zip(prompts, audio):
            s = eng.add_request(prompt, max_new=6, audio_embeds=wrap(a))
            eng.run_to_completion()
            got.append(list(eng.outputs[s]))
        outs.append(got)
    assert outs[1] == outs[0]
    _, fresh = _engines(ref, batch_slots=1, max_len=32)
    fresh.add_request(prompts[1], max_new=6,
                      audio_embeds=torch.from_numpy(audio[1]))
    fresh.run_to_completion()
    assert fresh.outputs[0] == outs[1][1]


def test_engine_ragged_batch_matches_reference(ref):
    """Two slots, the second request admitted mid-flight: the same tokens
    as the reference's engine."""
    rc = ref[0]
    audio = [_audio(rc, 1, 14)[0], _audio(rc, 1, 15)[0]]
    outs = []
    for eng, wrap in zip(_engines(ref, batch_slots=2, max_len=32),
                         (jnp.asarray, torch.from_numpy)):
        eng.add_request([11, 22, 33], max_new=8, audio_embeds=wrap(audio[0]))
        eng.step()
        eng.add_request([4, 5], max_new=4, audio_embeds=wrap(audio[1]))
        eng.run_to_completion()
        outs.append(eng.outputs)
    assert outs[1] == outs[0]


def test_engine_needs_audio(ref):
    _, port = _engines(ref, batch_slots=1, max_len=16)
    with pytest.raises(ValueError, match="audio_embeds"):
        port.add_request([1, 2], max_new=2)


def test_greedy_continuation_matches_rollout(ref):
    """N greedy engine steps == N teacher-forced forward re-evaluations
    with the same audio (the port alone)."""
    _, _, pc, tp = _port(ref)
    audio = torch.from_numpy(_audio(pc, 1, 16))
    prompt = [7, 21, 3]
    eng = DecodeEngine(pc, tp, EngineConfig(batch_slots=1, max_len=32,
                                            cache_dtype="float32",
                                            device="cpu"))
    eng.add_request(prompt, max_new=6, audio_embeds=audio[0])
    eng.run_to_completion()
    seq, want = list(prompt), []
    for _ in range(6):
        lg = api.forward_logits(tp, pc, {"tokens": torch.tensor([seq]),
                                         "audio_embeds": audio},
                                last_only=True)
        want.append(int(torch.argmax(lg[0, -1])))
        seq.append(want[-1])
    assert eng.outputs[0] == want


# ------------------------------------------------------------- training
def test_adamw_step_matches_reference(ref):
    """One ``make_train_step`` step with audio and bf16 moments: the loss
    within rel 1e-5, the parameters within atol 1e-4 where Adam's first
    step is well posed; the stacked biases and gains decay."""
    rc, rp, pc, tp = _port(ref)
    opt = AdamWConfig(lr=1e-2)
    rb, pb = _batches(rc, 4, 16, 17)
    _, rg = jax.value_and_grad(lambda p: ref_api.loss_fn(p, rc, rb))(rp)
    rg = {k: np.asarray(v) for k, v in convert._flatten(rg)}
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


def test_microbatches_split_the_audio(ref):
    """Two strided microbatches (audio split with the tokens) give the
    full batch's loss and gradients."""
    _, _, pc, tp = _port(ref)
    _, pb = _batches(pc, 4, 8, 18)
    l1, g1 = loss_and_grads(tp, pc, pb, 1)
    l2, g2 = loss_and_grads(tp, pc, pb, 2)
    assert float(l2) == pytest.approx(float(l1), rel=1e-5)
    for n in g1:
        np.testing.assert_allclose(g2[n].numpy(), g1[n].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def _ref_draws(key, n, probes):
    _, sub = jax.random.split(key)
    return [np.asarray(jax.random.rademacher(k, (n,), dtype=jnp.float32))
            for k in jax.random.split(sub, probes)]


def _ref_cggn_fns(rc, rb):
    def ref_logits(p):
        return ref_api.forward_logits(p, rc, rb)

    def ref_loss(lg):
        lse = jax.nn.logsumexp(lg, axis=-1)
        return jnp.mean(lse - jnp.take_along_axis(
            lg, rb["labels"][..., None], axis=-1)[..., 0])

    return ref_logits, ref_loss


def test_ggn_matvec_matches_reference(ref):
    """The GGN matvec with audio (``lm_ggn_fns``) against the reference's
    on ``forward_logits(p, cfg, batch)``: ``tests/test_torch_gn.py``'s
    fp32 tolerances (rtol 1e-4, atol 1e-5)."""
    from repro.core import gn as RG
    rc, rp, pc, tp = _port(ref)
    rb, pb = _batches(rc, 2, 12, 19)
    mv_r, n = RG.make_ggn_matvec(*_ref_cggn_fns(rc, rb)[::-1], rp, 1e-3)
    mv_p, n_p = G.make_ggn_matvec(*lm_ggn_fns(tp, pb)[::-1], tp, 1e-3)
    assert n_p == n
    v = (np.random.default_rng(22).standard_normal(n) * 0.1).astype(
        np.float32)
    want = np.asarray(mv_r(jnp.asarray(v)))
    got = convert.lm_flat_from_torch(
        mv_p(convert.lm_flat_to_torch(v, pc, device="cpu")), pc)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


#: ‖δ_port − δ_ref‖ / ‖δ_ref‖ after one step by CG iterations.  The fp32 CG
#: grows the packages' rounding differences with each iteration, faster on
#: whisper (logits up to ~57: a nearly singular softmax Hessian) than on
#: the dense LM: measured 2.4e-5, 4.2e-5, 8.4e-5 after 1, 2, 4 iterations
#: and 2.0e-3 after 8 on this batch (the matvec itself agrees to 4.4e-6)
CGGN_DELTA_RTOL = {4: 1e-3, 8: 2e-2}


@pytest.mark.parametrize("cg_iters", sorted(CGGN_DELTA_RTOL))
def test_cggn_step_matches_reference(ref, monkeypatch, cg_iters):
    """One ``cggn_lm_step`` with audio (``tpu_fp32``, 4 probes: the
    launcher's settings at 8 CG iterations, and at 4; the reference's probe
    draws reordered as the port's flat vector) against the reference's
    CGGN step, whose ``logits_fn`` is ``forward_logits(p, cfg, batch)``:
    the loss within rel 1e-5, ‖g‖ and ‖δ‖ within rel 1e-4, the update δ
    within :data:`CGGN_DELTA_RTOL` of its norm."""
    rc, rp, pc, tp = _port(ref)
    rb, pb = _batches(rc, 2, 12, 19)
    ccfg = dict(cg_iters=cg_iters, scheme="tpu_fp32", lr=1.0)
    ref_logits, ref_loss = _ref_cggn_fns(rc, rb)
    st = RC.cggn_init(rp, KEY)
    p_r, _, m_r = RC.cggn_update(
        rp, st, loss_logits_fn=ref_loss, logits_fn=ref_logits,
        loss_value_and_grad=lambda p: jax.value_and_grad(
            lambda q: ref_loss(ref_logits(q)))(p),
        cfg=RC.CGGNConfig(**ccfg))
    draws = iter([convert.lm_flat_to_torch(d, pc, device="cpu") for d in
                  _ref_draws(KEY, int(st.diag.shape[0]), 4)])
    monkeypatch.setattr(G, "_rademacher",
                        lambda n, gen, dtype: next(draws).to(dtype))
    st_p = convert.cggn_state_to_torch(st, pc, device="cpu")
    before = dict(convert._flatten(rp))
    model, st_p, m_p = cggn_lm_step(tp, st_p, pb, C.CGGNConfig(**ccfg))
    assert float(m_p["loss"]) == pytest.approx(float(m_r["loss"]), rel=1e-5)
    for k in ("delta_norm", "grad_norm"):
        assert float(m_p[k]) == pytest.approx(float(m_r[k]), rel=1e-4)
    assert 1 <= m_p["cg_iters"] <= cg_iters and st_p.step == 1
    got = dict(convert._flatten(convert.lm_params_from_torch(model, pc)))
    num = den = 0.0
    for path, want in convert._flatten(p_r):
        want = np.asarray(want, np.float64)
        num += np.sum(np.square(got[path] - want))
        den += np.sum(np.square(want - np.asarray(before[path])))
    assert math.sqrt(num / den) <= CGGN_DELTA_RTOL[cg_iters]


def test_lm_ggn_fns_feed_the_audio(ref):
    """``lm_ggn_fns``' logits are ``forward_logits`` on the batch, audio
    included (the model run through ``functional_call``)."""
    _, _, pc, tp = _port(ref)
    _, pb = _batches(pc, 2, 8, 20)
    logits_fn, loss_logits = lm_ggn_fns(tp, pb)
    got = logits_fn(G.param_dict(tp))
    want = api.forward_logits(tp, pc, pb)
    assert torch.equal(got, want)
    assert float(loss_logits(got)) == pytest.approx(
        float(api.loss_fn(tp, pc, pb)), rel=1e-6)


class _AudioLM:
    """``SyntheticLM`` tokens with frame embeddings drawn from (seed,
    step): the batches the reference's whisper training takes."""

    def __init__(self, cfg, b, s):
        self.cfg, self.b = cfg, b
        self.lm = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=s,
                                         global_batch=b), device="cpu")

    def batch_at(self, step):
        batch = self.lm.batch_at(step)
        batch["audio_embeds"] = torch.from_numpy(_audio(self.cfg, self.b,
                                                        100 + step))
        return batch

    def cursor(self, step):
        return self.lm.cursor(step)


def test_trainer_checkpoint_resume_bitwise(ref, tmp_path):
    """A whisper ``Trainer`` (AdamW, bf16 moments) checkpoints at step 2;
    a trainer on other parameters resumes there and its next 2 steps give
    the uninterrupted run's losses and parameters bit for bit."""
    pc = get_config(ARCH).reduced()
    opt = AdamWConfig(lr=5e-3)
    step = make_train_step(pc, opt=opt, device="cpu")
    data = _AudioLM(pc, 2, 8)

    def trainer(seed, **tc):
        model = api.init_params(pc, torch.Generator().manual_seed(seed),
                                device="cpu")
        return Trainer(pc, data, step, model, adamw_init(model, opt),
                       TrainerConfig(log_every=0, **tc),
                       torch.Generator().manual_seed(seed))

    full = trainer(0, total_steps=4, ckpt_every=0,
                   ckpt_dir=str(tmp_path / "x"))
    log = full.run()
    assert all(math.isfinite(m["loss"]) for m in log)
    trainer(0, total_steps=2, ckpt_every=2, ckpt_dir=str(tmp_path)).run()
    tr2 = trainer(1, ckpt_dir=str(tmp_path))
    assert tr2.try_resume() and tr2.step == 2
    log2 = tr2.run(steps=2)
    assert [m["loss"] for m in log2] == [m["loss"] for m in log[2:]]
    for (n, a), (_, b) in zip(tr2.params.named_parameters(),
                              full.params.named_parameters()):
        assert torch.equal(a, b), n


def test_checkpoint_roundtrip_reference_layout(ref, tmp_path):
    """The reference's whisper tree (``dec_layers``, ``embed``,
    ``enc_layers``, ``enc_ln``, ``ln_f``) saved by the reference restores
    in the port bit for bit, and the port's save of it in the
    reference."""
    rc, rp, pc, tp = _port(ref)
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


# ------------------------------------------------------------ conversion
def test_convert_params_roundtrip_and_order(ref):
    """Parameters carried across and back are the reference's bit for bit,
    in its ravel order (sorted key paths), the layers unstacked over each
    stack's own depth."""
    rc, rp, pc, tp = _port(ref)
    back = convert.lm_params_from_torch(tp, pc)
    assert list(back) == ["dec_layers", "embed", "enc_layers", "enc_ln",
                          "ln_f"]
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(rp)[0]):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    assert back["enc_layers"]["attn"]["wq"]["w"].shape[0] == \
        pc.encoder.n_layers
    assert back["dec_layers"]["xattn"]["wk"]["b"].shape[0] == pc.n_layers
    assert tp.enc_layers[1].attn.wq.w.shape == (pc.d_model, pc.d_model)


def test_convert_flat_roundtrip(ref):
    """A vector in the reference's ravel order, reordered as the port's
    ``flatten_like`` and back: the same values, each at its parameter."""
    rc, rp, pc, tp = _port(ref)
    flat_ref, _ = ravel_pytree(rp)
    flat = convert.lm_flat_to_torch(np.asarray(flat_ref), pc, device="cpu")
    port_flat, ravel, _ = G.flatten_like(tp)
    assert torch.equal(flat, port_flat)
    assert torch.equal(flat, ravel(G.param_dict(tp)))
    np.testing.assert_array_equal(convert.lm_flat_from_torch(flat, pc),
                                  np.asarray(flat_ref))


def test_convert_cache_roundtrip(ref):
    """A reference cache (self ``AttnCache`` and bare cross arrays, bf16)
    arrives bit for bit: the cross K/V as bare tensors."""
    rc, rp = ref
    cache = _ref_decode_cache(rc, rp, _audio(rc, 2, 21), 8)
    cache = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), cache)
    got = convert.lm_cache_to_torch(cache, device="cpu")
    assert set(got) == {"self", "cross_k", "cross_v"}
    assert isinstance(got["cross_v"], torch.Tensor) and not got["self"].ring
    for name in ("cross_k", "cross_v"):
        assert got[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(cache[name], np.float32))
    np.testing.assert_array_equal(got["self"].k.float().numpy(),
                                  np.asarray(cache["self"].k, np.float32))


def test_decays_counts_the_stacked_layer_axis(ref):
    """AdamW decays ``enc_layers.<l>.*`` and ``dec_layers.<l>.*`` biases and
    gains (``[L, d]`` leaves in the reference), not ``enc_ln``'s or
    ``ln_f``'s."""
    rc, rp, pc, tp = _port(ref)
    ref_leaves = dict(convert._flatten(rp))
    for name, p in tp.named_parameters():
        top, _, rest = name.partition(".")
        path = name if top not in ("enc_layers", "dec_layers") \
            else f"{top}.{rest.split('.', 1)[1]}"
        assert decays(name, p) == (np.ndim(ref_leaves[path]) >= 2), name
    assert decays("enc_layers.0.ln1.g", tp.enc_layers[0].ln1.g)
    assert decays("dec_layers.3.xattn.wq.b", tp.dec_layers[3].xattn.wq.b)
    assert not decays("enc_ln.g", tp.enc_ln.g)
    assert not decays("ln_f.b", tp.ln_f.b)


def test_init_params_counts_the_full_config():
    """At full width, on the meta device: 70,686,208 parameters, the
    reference's ``init_params``."""
    model = api.init_params(get_config(ARCH), torch.Generator(),
                            device="meta")
    shapes = jax.eval_shape(lambda: ref_api.init_params(
        ref_get_config(ARCH), KEY))
    ref_n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        shapes))
    assert api.count_params(model) == ref_n == 70_686_208


# --------------------------------------------------------------- launch
def test_launch_serve_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--max-new", "4", "--max-len", "32"])
    assert "3 requests, 12 tokens" in capsys.readouterr().out


def test_launch_train_refuses_whisper(tmp_path):
    """The synthetic data has no audio: the launcher raises before any
    work, as the reference's does (``KeyError: 'audio_embeds'``)."""
    with pytest.raises(KeyError, match="audio_embeds"):
        import repro.launch.train as ref_launch
        ref_launch.main(["--arch", ARCH, "--steps", "1", "--seq-len", "8",
                         "--batch", "2", "--ckpt-dir", str(tmp_path / "r")])
    with pytest.raises(ValueError, match="audio_embeds"):
        launch_train.main(["--arch", ARCH, "--device", "cpu", "--steps",
                           "1", "--ckpt-dir", str(tmp_path)])
