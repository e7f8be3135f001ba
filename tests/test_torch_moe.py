"""The port's MoE FFN (``repro_torch.models.moe``) and the MoE family's
serving against the JAX package's, on the CPU at fp32: the same numpy
inputs and the reference's own parameters (carried across by
``repro_torch.convert``) go through both.

* routing: the same chosen experts and the same kept picks as the
  reference's code (``jax.lax.top_k`` on its fp32 gates, the exclusive
  cumsum ranks, the capacity).  A pick that differs must be a near tie:
  its gates within 1e-6 (reported, never re-seeded);
* ``moe_ffn`` within atol = rtol = 1e-4: granite-moe's reduced shape
  (E 8, top-2), llama4-scout's (E 8, top-1), a capacity that drops
  tokens, several groups with a padded last one (n not a multiple of
  ``GROUP``), and the reference test's cases (dropped tokens give zero
  rows; one expert equals its dense SwiGLU);
* ``DecodeEngine`` on the reduced granite-moe: the same greedy tokens as
  the reference's engine with 3 slots, 5 requests and reused slots (the
  frozen slots' tokens route in every tick, as the reference's do).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.models import moe as RM
from repro.models.config import MoEConfig as RefMoEConfig
from repro.serve import DecodeEngine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import moe as M
from repro_torch.models.config import MoEConfig
from repro_torch.serve import DecodeEngine, EngineConfig

KEY = jax.random.PRNGKey(0)
TOL = dict(atol=1e-4, rtol=1e-4)
#: a pick the packages may order differently: gates this close
TIE = 1e-6

#: (id, E, K, capacity factor, d, f, B, S); the first two are the
#: reduced granite-moe's and llama4-scout's MoE (``cfg.reduced()``)
CASES = [("granite-reduced", 8, 2, 1.25, 128, 256, 2, 40),
         ("llama4-reduced", 8, 1, 1.25, 128, 256, 2, 40),
         ("drops", 4, 2, 0.5, 32, 64, 1, 96),
         ("groups-padded", 8, 2, 1.25, 32, 64, 3, 700),
         ("granite-experts", 32, 8, 1.25, 64, 32, 1, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many tiny ops: the suite runs
    several workers on the same cores, and busy-waiting thread pools slow
    tiny ops there by 50×.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _moe(E, K, cf, d, f, seed=0):
    rcfg = RefMoEConfig(n_experts=E, top_k=K, capacity_factor=cf)
    rp = RM.init_moe(jax.random.PRNGKey(seed), d, f, rcfg)
    pcfg = MoEConfig(n_experts=E, top_k=K, capacity_factor=cf)
    return rcfg, rp, pcfg, convert.load_tree(M.MoE(d, f, pcfg), rp)


def _ref_routing(rp, x, cfg):
    """The reference's routing (``moe.py``'s lines from the router to
    ``keep``), on its own fp32 gates: (gates, tope, keep)."""
    n, d = x.shape[0] * x.shape[1], x.shape[2]
    g_sz = min(RM.GROUP, n)
    n_pad = math.ceil(n / g_sz) * g_sz
    xt = jnp.concatenate([jnp.asarray(x).reshape(n, d),
                          jnp.zeros((n_pad - n, d), jnp.float32)])
    xg = xt.reshape(n_pad // g_sz, g_sz, d)
    gates = jax.nn.softmax(jnp.einsum("gsd,de->gse", xg, rp["router"]["w"]),
                           axis=-1)
    _, tope = jax.lax.top_k(gates, cfg.top_k)
    cap = max(1, math.ceil(g_sz * cfg.top_k * cfg.capacity_factor
                           / cfg.n_experts))
    sel = jax.nn.one_hot(tope, cfg.n_experts, dtype=jnp.int32)
    flat = sel.reshape(xg.shape[0], g_sz * cfg.top_k, cfg.n_experts)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos.reshape(sel.shape) * sel, axis=-1)
    return np.asarray(gates), np.asarray(tope), np.asarray(pos < cap)


def _port_routing(tp, x, cfg):
    n, d = x.shape[0] * x.shape[1], x.shape[2]
    g_sz = min(M.GROUP, n)
    n_pad = math.ceil(n / g_sz) * g_sz
    xt = torch.cat([torch.from_numpy(x).reshape(n, d),
                    torch.zeros(n_pad - n, d)])
    tope, _, pos, cap = M.route(tp, xt.reshape(n_pad // g_sz, g_sz, d), cfg)
    return tope.numpy(), (pos < cap).numpy()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_routing_matches_reference(case):
    _, E, K, cf, d, f, b, s = case
    rcfg, rp, pcfg, tp = _moe(E, K, cf, d, f)
    x = _x((b, s, d), 1)
    gates, ref_e, ref_keep = _ref_routing(rp, x, rcfg)
    got_e, got_keep = _port_routing(tp, x, pcfg)
    flipped = np.argwhere((got_e != ref_e).any(-1))
    for g, t in flipped:            # only near ties may order otherwise
        mine = np.sort(gates[g, t][got_e[g, t]])
        theirs = np.sort(gates[g, t][ref_e[g, t]])
        gap = np.abs(mine - theirs).max()
        assert gap < TIE, f"group {g} token {t}: gates differ by {gap}"
    if len(flipped):
        print(f"{len(flipped)} near-tie picks differ (gates within {TIE})")
    else:
        np.testing.assert_array_equal(got_keep, ref_keep)
    if case[0] == "drops":
        assert not ref_keep.all()             # the capacity bites
    assert ref_keep.any()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_ffn_matches_reference(case):
    _, E, K, cf, d, f, b, s = case
    rcfg, rp, pcfg, tp = _moe(E, K, cf, d, f)
    x = _x((b, s, d), 2)
    got = M.moe_ffn(tp, torch.from_numpy(x), pcfg)
    want = RM.moe_ffn(rp, jnp.asarray(x), rcfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_moe_ffn_bf16_matches_reference():
    """bf16 compute (the router and combine stay fp32): within 2e-2 of the
    output's scale (bf16 keeps 8 bits; the packages round other
    intermediates)."""
    rcfg, rp, pcfg, tp = _moe(8, 2, 1.25, 64, 128)
    x = _x((2, 24, 64), 3)
    got = M.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16), pcfg)
    want = np.asarray(RM.moe_ffn(rp, jnp.asarray(x, jnp.bfloat16), rcfg),
                      np.float32)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max()


def test_capacity_drops_tokens():
    """capacity_factor ≪ 1: overflow tokens are dropped (zero rows, not
    corrupted) — the reference test's case."""
    rcfg, rp, pcfg, tp = _moe(2, 1, 0.1, 16, 32)
    x = _x((1, 64, 16), 4)
    y = M.moe_ffn(tp, torch.from_numpy(x), pcfg)
    assert bool(torch.isfinite(y).all())
    assert int((y[0].abs().amax(-1) == 0).sum()) >= 32
    np.testing.assert_allclose(y.numpy(), np.asarray(
        RM.moe_ffn(rp, jnp.asarray(x), rcfg)), **TOL)


def test_top1_equals_dense_single_expert():
    """n_experts = 1 == its sole expert's SwiGLU."""
    _, _, pcfg, tp = _moe(1, 1, 2.0, 16, 32)
    x = torch.from_numpy(_x((1, 8, 16), 5))
    h = torch.nn.functional.silu(x @ tp.wg[0]) * (x @ tp.wi[0])
    np.testing.assert_allclose(M.moe_ffn(tp, x, pcfg).numpy(),
                               (h @ tp.wo[0]).numpy(), atol=1e-5)


def test_dropped_picks_are_not_renormalized():
    """The reference's code (not its docstring): a token that loses one of
    its two picks to the capacity keeps the other pick's weight as
    renormalized over both picks, so its kept weights sum below 1."""
    _, _, pcfg, tp = _moe(4, 2, 0.5, 32, 64)
    xg = torch.from_numpy(_x((1, 96, 32), 6))
    _, w_kept, pos, cap = M.route(tp, xg, pcfg)
    partial = ((pos < cap).sum(-1) == 1)
    assert bool(partial.any())
    assert float(w_kept.sum(-1)[partial].max()) < 1 - 1e-3


def test_cases_are_the_reduced_configs():
    for case, arch in zip(CASES, ("granite-moe-1b-a400m",
                                  "llama4-scout-17b-a16e")):
        c = get_config(arch).reduced()
        assert case[1:6] == (c.moe.n_experts, c.moe.top_k,
                             c.moe.capacity_factor, c.d_model, c.d_ff)


def test_init_draws_reference_scales():
    from repro_torch.models.layers import draw_parameters
    m = draw_parameters(M.MoE(64, 256, MoEConfig(8, 2)),
                        torch.Generator().manual_seed(0))
    for w, scale in ((m.wi, 64 ** -0.5), (m.wg, 64 ** -0.5),
                     (m.wo, 256 ** -0.5), (m.router.w, 64 ** -0.5)):
        assert float(w.abs().max()) <= 2 * scale
        assert float(w.std()) == pytest.approx(0.88 * scale, rel=0.05)
    assert not torch.equal(m.wi, m.wg)


# ----------------------------------------------------------------- serve
@pytest.fixture(scope="module")
def granite():
    rc = ref_get_config("granite-moe-1b-a400m").reduced()
    pc = get_config("granite-moe-1b-a400m").reduced()
    rp = ref_api.init_params(rc, KEY)
    return rc, rp, pc, convert.lm_params_to_torch(rp, pc, device="cpu")


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 512, n)]


def _five_requests(eng):
    prompts = [(_prompt(5, 1), 4), (_prompt(3, 2), 6), (_prompt(7, 3), 3),
               (_prompt(4, 4), 5), (_prompt(6, 5), 4)]
    outs, owner = {}, {}
    while prompts or eng.active.any():
        while prompts and (~eng.active).any():
            rid = 5 - len(prompts)
            prompt, max_new = prompts.pop(0)
            owner[eng.add_request(prompt, max_new=max_new)] = rid
        for slot in eng.step():
            if not eng.active[slot]:
                outs[owner[slot]] = list(eng.outputs[slot])
    return [outs[i] for i in range(5)]


def test_engine_greedy_matches_reference(granite):
    rc, rp, pc, tp = granite
    kw = dict(batch_slots=3, max_len=64, cache_dtype="float32")
    ref = RefEngine(rc, rp, RefEngineConfig(**kw))
    port = DecodeEngine(pc, tp, EngineConfig(device="cpu", **kw))
    want = _five_requests(ref)
    assert _five_requests(port) == want
    np.testing.assert_array_equal(port.pos, ref.pos)
