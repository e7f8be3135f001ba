"""The port's ``DecodeEngine`` against the JAX package's, on the CPU at fp32.

Greedy outputs must equal the reference engine's token for token on the
same reduced configs, parameters (carried across by ``convert``) and
prompts: ragged admission mid-flight, a prompt longer than the reduced
window (the ring wraps during prefill), slot reuse, and EOS.  Temperature
sampling draws from a ``torch.Generator``, not ``jax.random``, so it is
held inside the port: the same seed gives the same tokens.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.serve import DecodeEngine as RefEngine
from repro.serve import EngineConfig as RefConfig

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import forward_logits, init_cache, init_params
from repro_torch.serve import (DecodeEngine, EngineConfig, cache_bytes,
                               slot_insert, slot_view)

KEY = jax.random.PRNGKey(0)
ARCHS = ["gemma3-1b-mixed", "h2o-danube-3-4b", "qwen2.5-32b"]


def _configs(arch):
    name = "gemma3-1b" if arch == "gemma3-1b-mixed" else arch
    rc, pc = ref_get_config(name).reduced(), get_config(name).reduced()
    if arch == "gemma3-1b-mixed":       # 6 layers: the 6th is global
        rc = dataclasses.replace(rc, n_layers=6)
        pc = dataclasses.replace(pc, n_layers=6)
    return rc, pc


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        rc, pc = _configs(arch)
        rp = ref_api.init_params(rc, KEY)
        out[arch] = (rc, rp, pc, convert.lm_params_to_torch(rp, pc,
                                                            device="cpu"))
    return out


def _engines(models, arch, **kw):
    rc, rp, pc, tp = models[arch]
    kw = dict(cache_dtype="float32", **kw)
    return (RefEngine(rc, rp, RefConfig(**kw)),
            DecodeEngine(pc, tp, EngineConfig(device="cpu", **kw)))


def _prompt(n, seed, vocab=512):
    return [int(t) for t in np.random.default_rng(seed).integers(1, vocab, n)]


def _ragged(eng):
    eng.add_request([11, 22, 33], max_new=8)
    eng.step()
    eng.add_request([4, 5], max_new=4)          # joins mid-flight
    eng.step()
    eng.add_request([99], max_new=3)
    eng.run_to_completion()
    return eng.outputs


def _long_prompt(eng):
    eng.add_request(_prompt(70, 1), max_new=6)  # 70 > the window (64)
    eng.add_request([7, 8, 9], max_new=10)
    eng.run_to_completion()
    return eng.outputs


def _reuse(eng):
    s0 = eng.add_request([1, 2, 3], max_new=3)
    eng.run_to_completion()
    first = list(eng.outputs[s0])
    s1 = eng.add_request([1, 2, 3], max_new=3)
    eng.run_to_completion()
    assert s1 == s0 and eng.outputs[s1] == first    # clean slot
    return [first, eng.outputs[s1]]


SCENARIOS = {"ragged": (_ragged, dict(batch_slots=3, max_len=64)),
             "long-prompt": (_long_prompt, dict(batch_slots=2, max_len=128)),
             "slot-reuse": (_reuse, dict(batch_slots=1, max_len=64))}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_matches_reference(models, arch, scenario):
    drive, kw = SCENARIOS[scenario]
    ref, port = _engines(models, arch, **kw)
    want = drive(ref)
    got = drive(port)
    assert got == want
    assert not port.active.any()
    np.testing.assert_array_equal(port.pos, ref.pos)


@pytest.mark.parametrize("arch", ARCHS)
def test_eos_matches_reference(models, arch):
    """EOS set to a token the reference's greedy run emits at step 3: both
    engines stop at its first appearance and free the slot."""
    ref, _ = _engines(models, arch, batch_slots=1, max_len=64)
    ref.add_request([1, 2], max_new=12)
    ref.run_to_completion()
    eos = ref.outputs[0][2]
    ref, port = _engines(models, arch, batch_slots=1, max_len=64,
                         eos_token=eos)
    for eng in (ref, port):
        eng.add_request([1, 2], max_new=12)
        eng.run_to_completion()
    assert port.outputs == ref.outputs
    assert port.outputs[0][-1] == eos and not port.active.any()


def test_prefill_matches_teacher_forcing(models):
    """argmax of the prefill logits == argmax of forward at the last
    position (port alone, as the reference's test)."""
    _, _, pc, tp = models["gemma3-1b-mixed"]
    prompt = [5, 9, 17, 3, 44, 8]
    want = int(torch.argmax(forward_logits(
        tp, pc, {"tokens": torch.tensor([prompt])})[0, -1]))
    eng = DecodeEngine(pc, tp, EngineConfig(batch_slots=1, max_len=32,
                                            cache_dtype="float32",
                                            device="cpu"))
    eng.add_request(prompt, max_new=1)
    assert eng.outputs[0][0] == want


def test_greedy_continuation_matches_rollout(models):
    """N greedy engine steps == N teacher-forced forward re-evaluations."""
    _, _, pc, tp = models["h2o-danube-3-4b"]
    prompt = [7, 21, 3]
    eng = DecodeEngine(pc, tp, EngineConfig(batch_slots=1, max_len=64,
                                            cache_dtype="float32",
                                            device="cpu"))
    eng.add_request(prompt, max_new=6)
    eng.run_to_completion()
    seq, want = list(prompt), []
    for _ in range(6):
        t = int(torch.argmax(forward_logits(
            tp, pc, {"tokens": torch.tensor([seq])})[0, -1]))
        want.append(t)
        seq.append(t)
    assert eng.outputs[0] == want


def test_temperature_sampling_deterministic_per_seed():
    cfg = get_config("qwen2.5-32b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def run(seed):
        e = DecodeEngine(cfg, params, EngineConfig(
            batch_slots=1, max_len=64, temperature=8.0, seed=seed,
            cache_dtype="float32", device="cpu"))
        e.add_request([9, 8, 7], max_new=24)
        e.run_to_completion()
        return e.outputs[0]

    assert run(0) == run(0)
    assert run(0) != run(1)


def test_slot_view_and_insert():
    """A slot view shares storage (writes land in the batched cache);
    inserting a separate batch-1 cache copies it into that slot only."""
    cfg = get_config("gemma3-1b").reduced()
    cache = init_cache(cfg, 3, 16, torch.float32, device="cpu")
    view = slot_view(cache, 1)
    view["ring"].k.fill_(2.0)
    assert float(cache["ring"].k[:, 1].min()) == 2.0
    assert float(cache["ring"].k[:, [0, 2]].abs().max()) == 0.0
    other = init_cache(cfg, 1, 16, torch.float32, device="cpu")
    other["ring"].v.fill_(3.0)
    slot_insert(cache, other, 2)
    assert float(cache["ring"].v[:, 2].min()) == 3.0
    assert float(cache["ring"].v[:, :2].abs().max()) == 0.0
    assert cache_bytes(cache) == 3 * cache_bytes(other)


def test_engine_defaults_to_cuda_and_refuses_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gemma3-1b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(cfg, params, EngineConfig())


def test_add_request_accepts_and_ignores_patch_embeds(models):
    """``add_request(..., patch_embeds=)``, as the reference's engine takes
    it: accepted and ignored, the prefill logits, tokens and cache
    unchanged."""
    rc, rp, pc, tp = models["gemma3-1b-mixed"]

    def serve(**kw):
        eng = DecodeEngine(pc, tp, EngineConfig(batch_slots=1, max_len=32,
                                                cache_dtype="float32",
                                                device="cpu"))
        logits, prefill = [], eng._prefill

        def recorded(*args):
            out = prefill(*args)
            logits.append(out[2])
            return out

        eng._prefill = recorded
        s = eng.add_request([3, 1, 4, 1, 5], max_new=4, **kw)
        eng.run_to_completion()
        leaves = [t for c in eng.cache.values() for t in (
            [c] if isinstance(c, torch.Tensor) else
            [getattr(c, f.name) for f in dataclasses.fields(c)])
            if isinstance(t, torch.Tensor)]
        return logits[0], eng.outputs[s], leaves

    logits, tokens, cache = serve()
    patch = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, pc.d_model)).astype(np.float32))
    logits_p, tokens_p, cache_p = serve(patch_embeds=patch)
    assert torch.equal(logits_p, logits) and tokens_p == tokens
    assert len(cache_p) == len(cache) > 0
    assert all(torch.equal(a, b) for a, b in zip(cache, cache_p))
