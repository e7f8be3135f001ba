"""The port's int8 KV cache (``repro_torch.serve.quant_cache``) against the
JAX package's, on the CPU.

* ``quantize_kv``: the reference's int8 values and fp32 scales bit for bit
  (both round half to even), rows of zeros, exact halves and ±absmax
  included; ``dequantize_kv`` the same products;
* ``attn_decode_quant`` over 24 steps on a full and on a ring cache from
  the reference's own attention parameters: the outputs within 1e-5 of
  the reference's largest magnitude, the int8 caches equal and the scales
  within rel 1e-6 (q/k/v are projected by each package's own matmul);
* the reference test's own checks, on the port: the int8 decode within
  5 % of ``attn_decode`` on an fp32 cache (max |Δ| / max |y|), under 0.6×
  the bytes of a bf16 cache, and the same greedy tokens as fp32 attention
  on a small model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

from repro.models import api as ref_api
from repro.models.attention import init_attention as ref_init_attention
from repro.models.config import ModelConfig as RefModelConfig
from repro.serve import quant_cache as RQ

from repro_torch import convert
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.serve import (QuantAttnCache, attn_decode_quant,
                               dequantize_kv, init_quant_cache, quantize_kv)
from repro_torch.serve.kv_cache import cache_bytes

KEY = jax.random.PRNGKey(0)
N_HEADS, N_KV, HD, D = 4, 2, 16, 64


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ------------------------------------------------------------- primitives
def _quant_inputs():
    x = _x((4, 8, 64), 1, 3.0)
    x[0, 0] = 0.0                                    # an all-zero row
    # exact halves: absmax 127 gives scale 1, so k + 0.5 rounds to even
    x[0, 1] = np.arange(-31.5, 32.0, dtype=np.float32)
    x[0, 1, 0] = 127.0
    x[1, 2] = -x[1, 2]
    return x


@pytest.mark.parametrize("case", ["normal", "halves", "tiny", "bf16"])
def test_quantize_kv_bitwise(case):
    if case == "tiny":
        x = _x((3, 5, 16), 2, 1e-9)          # absmax below the 1e-8 floor
    elif case == "normal":
        x = _x((2, 3, 7, 32), 3, 0.7)
    else:
        x = _quant_inputs()
    ref_in = jnp.asarray(x)
    port_in = torch.from_numpy(x)
    if case == "bf16":
        ref_in = ref_in.astype(jnp.bfloat16)
        port_in = port_in.to(torch.bfloat16)
    q_r, s_r = RQ.quantize_kv(ref_in)
    q, s = quantize_kv(port_in)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(s_r).view(np.uint32))
    np.testing.assert_array_equal(
        dequantize_kv(q, s).numpy(),
        np.asarray(RQ.dequantize_kv(q_r, s_r)))


def test_quantize_rounds_half_to_even():
    q, s = quantize_kv(torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]]))
    assert float(s[0]) == 1.0
    assert q[0].tolist() == [127, 0, 2, 2, 0, -2]


def test_roundtrip_error_bound_and_positive_scale():
    """The reference test's bounds: |x − deq(q)| ≤ scale / 2; an all-zero
    row gets a positive scale and zero values."""
    x = torch.from_numpy(_x((4, 8, 64), 4, 3.0))
    q, s = quantize_kv(x)
    assert bool(((dequantize_kv(q, s) - x).abs()
                 <= s[..., None] * 0.5 + 1e-6).all())
    q0, s0 = quantize_kv(torch.zeros(2, 3, 16))
    assert bool((s0 > 0).all()) and not bool(q0.any())


# ------------------------------------------------------------------ decode
def _attn_params():
    rp = ref_init_attention(KEY, D, N_HEADS, N_KV, HD)
    tp = A.Attention(D, N_HEADS, N_KV, HD, device="cpu")
    convert.load_tree(tp, rp)
    return rp, tp


def _roll(decode, p, cache, xs, wrap, **kw):
    outs = []
    for t in range(xs.shape[1]):
        y, cache = decode(p, wrap(xs[:, t:t + 1]), cache, wrap(np.array(t)),
                          n_heads=N_HEADS, n_kv_heads=N_KV, head_dim=HD, **kw)
        outs.append(np.asarray(y))
    return np.concatenate(outs, 1), cache


@pytest.mark.parametrize("ring", [False, True], ids=["full", "ring"])
def test_attn_decode_quant_matches_reference(ring):
    """24 steps; the ring (length 8, window 8) wraps three times."""
    rp, tp = _attn_params()
    xs = _x((2, 24, D), 5)
    length, kw = (8, dict(window=8)) if ring else (24, {})
    y_r, c_r = _roll(RQ.attn_decode_quant, rp,
                     RQ.init_quant_cache(2, length, N_KV, HD, ring=ring), xs,
                     jnp.asarray, **kw)
    cache = init_quant_cache(2, length, N_KV, HD, ring=ring, device="cpu")
    y, c = _roll(attn_decode_quant, tp, cache, xs, torch.from_numpy, **kw)
    assert c is cache                                 # written in place
    assert np.abs(y - y_r).max() <= 1e-5 * np.abs(y_r).max()
    np.testing.assert_array_equal(c.k.numpy(), np.asarray(c_r.k))
    np.testing.assert_array_equal(c.v.numpy(), np.asarray(c_r.v))
    np.testing.assert_allclose(c.k_scale.numpy(), np.asarray(c_r.k_scale),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(c.v_scale.numpy(), np.asarray(c_r.v_scale),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("ring", [False, True], ids=["full", "ring"])
def test_quant_decode_close_to_fp32_attention(ring):
    """The reference test's bound on the port: max |Δ| / max |y| < 0.05
    against ``attn_decode`` on an fp32 cache."""
    _, tp = _attn_params()
    xs = _x((2, 24, D), 6)
    length, kw = (8, dict(window=8)) if ring else (24, {})
    y_f, _ = _roll(A.attn_decode, tp,
                   A.init_attn_cache(2, length, N_KV, HD, ring=ring,
                                     dtype=torch.float32, device="cpu"),
                   xs, torch.from_numpy, **kw)
    y_q, _ = _roll(attn_decode_quant, tp,
                   init_quant_cache(2, length, N_KV, HD, ring=ring,
                                    device="cpu"),
                   xs, torch.from_numpy, **kw)
    assert np.abs(y_f - y_q).max() / (np.abs(y_f).max() + 1e-6) < 0.05


def test_cache_is_under_0_6_of_bf16_bytes():
    full = A.init_attn_cache(4, 128, 2, 64, dtype=torch.bfloat16,
                             device="cpu")
    quant = init_quant_cache(4, 128, 2, 64, device="cpu")
    assert isinstance(quant, QuantAttnCache)
    qb, fb = cache_bytes({"q": quant}), cache_bytes({"f": full})
    assert qb < 0.6 * fb
    assert qb == 4 * 2 * 128 * (2 * 64 + 2 * 4)      # int8 + fp32 scales


def test_argmax_agreement_end_to_end():
    """The reference test's small model (2 layers, d 64, GQA 4:2): greedy
    decode through the int8 cache picks the same 12 tokens as through fp32
    attention — and as the reference's int8 rollout."""
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                      head_dim=16, dtype="float32", remat=False)
    rcfg = RefModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                          head_dim=16, dtype="float32", remat=False)
    rparams = ref_api.init_params(rcfg, KEY)
    params = convert.lm_params_to_torch(rparams, cfg, device="cpu")

    def rollout(quant):
        if quant:
            caches = [init_quant_cache(1, 32, 2, 16, device="cpu")
                      for _ in range(cfg.n_layers)]
        else:
            caches = [A.init_attn_cache(1, 32, 2, 16, dtype=torch.float32,
                                        device="cpu")
                      for _ in range(cfg.n_layers)]
        decode = attn_decode_quant if quant else A.attn_decode
        tok, out = torch.tensor([7]), []
        for t in range(12):
            x = L.embed(params.embed, tok[:, None], torch.float32)
            for lp, c in zip(params.layers, caches):
                y, _ = decode(lp.attn, L.norm(lp.ln1, x, cfg.norm_eps), c, t,
                              n_heads=4, n_kv_heads=2, head_dim=16)
                x = x + y
                x = x + L.ffn(lp.mlp, L.norm(lp.ln2, x, cfg.norm_eps))
            x = L.norm(params.ln_f, x, cfg.norm_eps)
            tok = torch.argmax(L.unembed(params.embed, x)[:, 0], dim=-1)
            out.append(int(tok[0]))
        return out

    def ref_rollout():
        from repro.models import layers as RL
        caches = [RQ.init_quant_cache(1, 32, 2, 16)
                  for _ in range(rcfg.n_layers)]
        tok, out = jnp.asarray([7]), []
        for t in range(12):
            x = RL.embed(rparams["embed"], tok[:, None], jnp.float32)
            for l in range(rcfg.n_layers):
                lp = jax.tree_util.tree_map(lambda a: a[l],
                                            rparams["layers"])
                y, caches[l] = RQ.attn_decode_quant(
                    lp["attn"], RL.norm(lp["ln1"], x, rcfg.norm_eps),
                    caches[l], jnp.asarray(t), n_heads=4, n_kv_heads=2,
                    head_dim=16)
                x = x + y
                x = x + RL.ffn(lp["mlp"], RL.norm(lp["ln2"], x,
                                                  rcfg.norm_eps))
            x = RL.norm(rparams["ln_f"], x, rcfg.norm_eps)
            tok = jnp.argmax(RL.unembed(rparams["embed"], x)[:, 0], axis=-1)
            out.append(int(tok[0]))
        return out

    want = rollout(False)
    assert rollout(True) == want == ref_rollout()


def test_init_quant_cache_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_quant_cache(1, 8, 1, 16)
