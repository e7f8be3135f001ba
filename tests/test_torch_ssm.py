"""The port's Mamba2 layer (``repro_torch.models.ssm``) and the SSM family's
serving against the JAX package's, on the CPU at fp32: the same numpy
inputs, and the reference's own parameters (carried across by
``repro_torch.convert``), go through both.

* ``_ssd_chunked``: the forward within 1e-5 of the output's scale at
  (s, chunk) ∈ {(32, 32), (40, 16), (128, 128)}; the gradient within
  1e-4 of its scale where the reference's is finite (chunk 32); at chunk
  128 the reference's dt gradient is not finite (it takes ``exp`` of the
  unmasked [Q, Q] square, whose upper triangle overflows: 0 · inf = NaN
  in the backward) and the port's is, within 1e-3 of the sequential
  recurrence's; the chunked scan equals the
  recurrence on the reference test's shapes (rtol = atol = 1e-4);
* ``mamba2_forward``, and ``mamba2_decode`` token by token, against the
  reference (atol = rtol = 1e-4) and against the forward (2e-3, the
  reference test's);
* ``DecodeEngine`` on the reduced mamba2 and zamba2: the same greedy
  tokens as the reference's engine with 3 slots, 5 requests and a reused
  slot; a reused slot keeps the finished request's SSM state in both
  packages (the reference's fault, followed): its first logits differ
  from a fresh slot's by the same amount in both;
* the cache bytes per slot, independent of ``max_len`` for mamba2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.models import ssm as RS
from repro.models.config import SSMConfig as RefSSMConfig
from repro.serve import DecodeEngine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve.kv_cache import bytes_per_slot as ref_bytes_per_slot

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import init_cache
from repro_torch.models import ssm as S
from repro_torch.models.config import SSMConfig
from repro_torch.serve import DecodeEngine, EngineConfig, bytes_per_slot

KEY = jax.random.PRNGKey(0)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many tiny ops: the suite runs
    several workers on the same cores, and busy-waiting thread pools slow
    tiny ops there by 50×.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or TOL))


def _close_scaled(got, want, tol):
    """|Δ| ≤ tol · max |want|: the tolerance of sums the two packages add
    in other orders, at the scale of their largest entry."""
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# ------------------------------------------------------------------- SSD
def _ssd_inputs(s, seed=0, b=2, h=3, p=4, n=5):
    """The probe of the reference's NaN: dt = softplus(N(0, 1)), a = −1."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.ones(h, np.float32)
    B = r.standard_normal((b, s, n)).astype(np.float32)
    C = r.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a, B, C


def _ref_ssd_grads(args, chunk):
    def f(x, dt, a, B, C):
        y, h = RS._ssd_chunked(x, dt, a, B, C, chunk)
        return jnp.sum(y * y) + jnp.sum(h)
    return jax.grad(f, argnums=(0, 1, 3, 4))(*map(jnp.asarray, args))


def _port_ssd_grads(args, chunk, fn=None):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    if fn is None:
        y, h = S._ssd_chunked(*ts, chunk)
    else:
        y, h = fn(*ts)
    (torch.sum(y * y) + torch.sum(h)).backward()
    return [ts[i].grad for i in (0, 1, 3, 4)]


def _recurrence(x, dt, a, B, C):
    """The sequential SSM (``tests/test_models.py``'s oracle) in torch:
    h = e^{aΔ}h + Δ·B⊗x; y = C·h."""
    b, s, h, p = x.shape
    state = x.new_zeros(b, h, p, B.shape[-1])
    ys = []
    for t in range(s):
        dec = torch.exp(dt[:, t] * a)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, t], B[:, t], x[:, t])
        state = dec[:, :, None, None] * state + upd
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t], state))
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("s,chunk", [(32, 32), (40, 16), (128, 128)])
def test_ssd_forward_matches_reference(s, chunk):
    """Within 1e-5 of the output's scale (an entry is a sum of up to
    ``chunk`` products of size ~max |want|: elementwise 1e-5 fails at chunk
    128, where entries near 0.3 move by 6e-5 of a max of 47)."""
    args = _ssd_inputs(s)
    y, h = S._ssd_chunked(*map(torch.from_numpy, args), chunk)
    ry, rh = RS._ssd_chunked(*map(jnp.asarray, args), chunk)
    _close_scaled(y, ry, 1e-5)
    _close_scaled(h, rh, 1e-5)


def test_ssd_gradient_matches_reference_where_finite():
    args = _ssd_inputs(32, seed=1)
    want = _ref_ssd_grads(args, 32)
    assert all(bool(jnp.isfinite(g).all()) for g in want)
    for g, w in zip(_port_ssd_grads(args, 32), want):
        _close_scaled(g, w, 1e-4)


@pytest.mark.parametrize("s", [128, 256])
def test_ssd_gradient_finite_where_reference_is_not(s):
    """At chunk 128 the reference's dt gradient is not finite; the port's
    is, and equals the sequential recurrence's (fp64) within 1e-3."""
    args = _ssd_inputs(s, seed=2)
    ref_dt = np.asarray(_ref_ssd_grads(args, 128)[1])
    assert not np.isfinite(ref_dt).all()
    got = _port_ssd_grads(args, 128)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    wide = [a.astype(np.float64) for a in args]
    want = _port_ssd_grads(wide, None, fn=_recurrence)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("s,chunk", [(8, 4), (12, 4), (16, 16), (9, 4)])
def test_chunked_ssd_matches_recurrence(s, chunk):
    r = np.random.default_rng(0)
    b, h, p, n = 2, 3, 4, 5
    x = torch.from_numpy(r.standard_normal((b, s, h, p)).astype(np.float32))
    dt = torch.from_numpy((r.random((b, s, h)) * 0.5 + 0.1).astype(
        np.float32))
    a = torch.from_numpy((-r.random(h) - 0.1).astype(np.float32))
    B = torch.from_numpy(r.standard_normal((b, s, n)).astype(np.float32))
    C = torch.from_numpy(r.standard_normal((b, s, n)).astype(np.float32))
    y, h_last = S._ssd_chunked(x, dt, a, B, C, chunk)
    y_ref, h_ref = _recurrence(x, dt, a, B, C)
    _close(y, y_ref)
    _close(h_last, h_ref)


def test_softplus_is_logaddexp():
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.9, 20.5, 40.0], np.float32)
    _close(S.softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)),
           atol=0, rtol=1e-7)


# ---------------------------------------------------------------- Mamba2
_CFG = dict(d_state=8, expand=2, d_conv=4, headdim=8, chunk=4)
D_MODEL = 16


def _mamba(seed=0):
    rp = RS.init_mamba2(jax.random.PRNGKey(seed), D_MODEL,
                        RefSSMConfig(**_CFG))
    # nonzero scalars, so A_log, D, dt_bias and conv_b all count
    rp = dict(rp, A_log=jnp.asarray(_x(rp["A_log"].shape, 3, 0.3)),
              dt_bias=jnp.asarray(_x(rp["dt_bias"].shape, 4, 0.3)),
              D=jnp.asarray(_x(rp["D"].shape, 5)),
              conv_b=jnp.asarray(_x(rp["conv_b"].shape, 6, 0.1)))
    tp = convert.load_tree(S.Mamba2(D_MODEL, SSMConfig(**_CFG)), rp)
    return rp, tp


def test_mamba2_parameters_match_reference_tree():
    rp, tp = _mamba()
    names = {n: tuple(p.shape) for n, p in tp.named_parameters()}
    assert names == {k: tuple(v.shape) for k, v in convert._flatten(rp)}


@pytest.mark.parametrize("state", [False, True], ids=["fresh", "with-state"])
def test_mamba2_forward_matches_reference(state):
    rp, tp = _mamba()
    x = _x((2, 13, D_MODEL), 7)
    kw = {}
    if state:
        kw = dict(conv_state=_x((2, 3, 2 * D_MODEL + 16), 8),
                  ssm_state=_x((2, 4, 8, 8), 9))
    ry, (rc, rs) = RS.mamba2_forward(
        rp, jnp.asarray(x), D_MODEL, RefSSMConfig(**_CFG), return_state=True,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    y, (c, s) = S.mamba2_forward(
        tp, torch.from_numpy(x), D_MODEL, SSMConfig(**_CFG),
        return_state=True, **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(y, ry)
    _close(c, rc)
    _close(s, rs)


def test_mamba2_decode_matches_reference_and_forward():
    rp, tp = _mamba()
    x = _x((2, 12, D_MODEL), 10)
    rc = RS.init_ssm_cache(2, D_MODEL, RefSSMConfig(**_CFG),
                           dtype=jnp.float32)
    tc = S.init_ssm_cache(2, D_MODEL, SSMConfig(**_CFG), dtype=torch.float32,
                          device="cpu")
    outs = []
    for t in range(12):
        y, tc = S.mamba2_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc,
                                D_MODEL, SSMConfig(**_CFG))
        ry, rc = RS.mamba2_decode(rp, jnp.asarray(x[:, t:t + 1]), rc,
                                  D_MODEL, RefSSMConfig(**_CFG))
        _close(y, ry)
        outs.append(y)
    _close(tc.conv, rc.conv)
    _close(tc.ssm, rc.ssm)
    full = S.mamba2_forward(tp, torch.from_numpy(x), D_MODEL,
                            SSMConfig(**_CFG))
    _close(torch.cat(outs, 1), full.numpy(), atol=2e-3, rtol=2e-3)


def test_mamba2_decode_rounds_state_to_cache_dtype():
    """A bf16 cache holds the state rounded once per token, as the
    reference's; the token's output reads the unrounded state."""
    rp, tp = _mamba()
    x = _x((1, 6, D_MODEL), 11)
    rc = RS.init_ssm_cache(1, D_MODEL, RefSSMConfig(**_CFG))
    tc = S.init_ssm_cache(1, D_MODEL, SSMConfig(**_CFG), device="cpu")
    for t in range(6):
        y, tc = S.mamba2_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc,
                                D_MODEL, SSMConfig(**_CFG))
        ry, rc = RS.mamba2_decode(rp, jnp.asarray(x[:, t:t + 1]), rc,
                                  D_MODEL, RefSSMConfig(**_CFG))
        _close(y, ry, atol=1e-3, rtol=1e-3)
    assert tc.ssm.dtype == torch.bfloat16
    np.testing.assert_allclose(tc.ssm.float().numpy(),
                               np.asarray(rc.ssm, np.float32),
                               rtol=2 ** -7, atol=1e-6)


# ----------------------------------------------------------------- serve
ENGINE_ARCHS = ["mamba2-780m", "zamba2-1.2b"]


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ENGINE_ARCHS:
        rc, pc = ref_get_config(arch).reduced(), get_config(arch).reduced()
        rp = ref_api.init_params(rc, KEY)
        out[arch] = (rc, rp, pc, convert.lm_params_to_torch(rp, pc,
                                                            device="cpu"))
    return out


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 512, n)]


def _five_requests(eng):
    """5 requests on 3 slots, admitted as slots free: slots are reused."""
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


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_greedy_matches_reference(models, arch):
    rc, rp, pc, tp = models[arch]
    kw = dict(batch_slots=3, max_len=64, cache_dtype="float32")
    ref = RefEngine(rc, rp, RefEngineConfig(**kw))
    port = DecodeEngine(pc, tp, EngineConfig(device="cpu", **kw))
    want = _five_requests(ref)
    assert _five_requests(port) == want
    np.testing.assert_array_equal(port.pos, ref.pos)


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_reused_slot_keeps_stale_state_as_reference(models, arch):
    """The reference prefills a reused slot from its current content, so
    the finished request's SSM state (advanced by every tick since) leaks
    into the next request.  The port does the same: a second prefill of the
    same prompt from the slot the first request left gives the reference's
    logits, and they differ from a fresh slot's by the same amount in both
    packages."""
    import copy
    rc, rp, pc, tp = models[arch]
    prompt = _prompt(6, 7)
    kw = dict(batch_slots=1, max_len=32, cache_dtype="float32")
    ref = RefEngine(rc, rp, RefEngineConfig(**kw))
    port = DecodeEngine(pc, tp, EngineConfig(device="cpu", **kw))
    for eng in (ref, port):
        eng.add_request(prompt, max_new=3)
        eng.run_to_completion()
    ref_logits = [np.asarray(ref._prefill(rp, c, jnp.asarray(prompt))[2])
                  for c in (ref.cache, ref_api.init_cache(
                      rc, 1, 32, dtype=jnp.float32))]
    port_logits = [port._prefill(c, torch.tensor(prompt))[2]
                   for c in (copy.deepcopy(port.cache), init_cache(
                       pc, 1, 32, torch.float32, device="cpu"))]
    for got, want in zip(port_logits, ref_logits):
        _close(got, want)
    ref_gap = np.abs(ref_logits[0] - ref_logits[1]).max()
    port_gap = float((port_logits[0] - port_logits[1]).abs().max())
    assert ref_gap > 1e-2
    assert port_gap == pytest.approx(ref_gap, rel=1e-3, abs=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bytes_per_slot(arch, dtype):
    got = bytes_per_slot(get_config(arch), 1024, getattr(torch, dtype))
    assert got == ref_bytes_per_slot(ref_get_config(arch), 1024,
                                     getattr(jnp, dtype))
    longer = bytes_per_slot(get_config(arch), 8192, getattr(torch, dtype))
    if arch == "mamba2-780m":            # O(1) in the context
        assert longer == got
    else:                                # the shared block's KV grows
        assert longer > got
