"""The port's ``flash_attention`` (its plain version on the CPU) against the
JAX package's Pallas kernel in interpret mode and its oracle ``mha_ref``.

The sweep is ``tests/test_flash_attn.py``'s, at its tolerances: causal
block pairs, windows 32 and 128, non-causal with S ≠ T, bf16 in and out,
×30 logits, and the composition with the model's ``attention()``.  Inputs
are made with numpy from a seed and handed to both packages.  The CUDA
kernels themselves are held against the plain version on the card by
``chip_smoke.py`` (phases 7 and 8); :func:`_tc_model` models the bf16
tensor-core kernels' arithmetic here, and :func:`_tf32x3_model` the fp32
one's (three TF32 products), so their precision contracts are held before
the card runs them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

from repro.kernels.flash_attn import flash_attention as ref_flash
from repro.kernels.ref import mha_ref
from repro.models import attention as ref_attn

from repro_torch import convert
from repro_torch.kernels import flash_attention
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import flash_attention_plain
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def _qkv(bh, s, t, d, seed=0):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(shape).astype(np.float32)
                 for shape in ((bh, s, d), (bh, t, d), (bh, t, d)))


def _both(arrays, dtype="float32"):
    """The same values as JAX and torch arrays (bf16 rounds the same way
    in both: to nearest even)."""
    jx = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays)
    tt = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays)
    return jx, tt


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _check(q, k, v, tol, dtype="float32", **kw):
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    got = flash_attention(tq, tk, tv, **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    want_kernel = ref_flash(jq, jk, jv, interpret=True, **kw)
    mask_kw = {n: kw[n] for n in ("causal", "window") if n in kw}
    want_ref = mha_ref(jq, jk, jv, **mask_kw)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    return got


@pytest.mark.parametrize("s,bq,bk", [(256, 128, 128), (256, 64, 256),
                                     (512, 128, 512), (128, 128, 128)])
def test_causal_sweep(s, bq, bk):
    _check(*_qkv(2, s, s, 64), 2e-5, causal=True, block_q=bq, block_k=bk)


@pytest.mark.parametrize("window", [32, 128])
def test_sliding_window(window):
    _check(*_qkv(2, 256, 256, 32), 2e-5, causal=True, window=window,
           block_q=64, block_k=64)


def test_non_causal_s_ne_t():
    _check(*_qkv(1, 128, 256, 64), 2e-5, causal=False, block_q=64,
           block_k=128)


def test_bf16_io_fp32_stats():
    _check(*_qkv(2, 256, 256, 64), 3e-2, dtype="bfloat16", causal=True,
           block_q=128, block_k=128)


def test_numerical_stability_large_logits():
    q, k, v = _qkv(1, 128, 128, 32)
    got = _check(30.0 * q, 30.0 * k, v, 1e-4, causal=True, block_q=64,
                 block_k=64)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("d", [16, 120])
def test_head_dims(d):
    """The smallest head dim of the reference's tests and h2o-danube's 120
    (not a multiple of 32), causal with a window."""
    _check(*_qkv(2, 128, 128, d, seed=d), 2e-5, causal=True, window=48,
           block_q=64, block_k=64)


def test_contract_matches_reference():
    """A sequence that is not a multiple of its block is refused in both
    packages, so a call valid in one is valid in the other."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 96, 96, 16))
    with pytest.raises(AssertionError):
        ref_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True)
    with pytest.raises(ValueError, match="block multiples"):
        flash_attention(tq, tk, tv, block_q=64, block_k=64)


def test_other_devices_raise():
    """Only a CPU tensor takes the plain version; a tensor elsewhere (here
    the meta device) is refused, not computed some other way."""
    q = torch.empty((1, 64, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("n_kv,window", [(4, None), (2, 48)],
                         ids=["mha", "gqa-window"])
def test_matches_model_attention(n_kv, window):
    """End to end, as the reference's ``test_matches_model_attention``:
    q/k/v built exactly as ``attention()`` builds them (dense, RoPE,
    head-major, kv heads repeated outside), the kernel, then ``wo`` — equal
    to the port's ``attention()`` and to the reference's."""
    d_model, h, hd, s = 64, 4, 16, 128
    p = ref_attn.init_attention(jax.random.PRNGKey(0), d_model, h, n_kv, hd)
    x = np.random.default_rng(5).standard_normal(
        (1, s, d_model)).astype(np.float32)
    kw = dict(n_heads=h, n_kv_heads=n_kv, head_dim=hd, window=window,
              rope_theta=10_000.0)
    want_ref = ref_attn.attention(p, jnp.asarray(x), **kw)

    tp = convert.load_tree(A.Attention(d_model, h, n_kv, hd), p)
    tx = torch.from_numpy(x)
    want = A.attention(tp, tx, **kw)

    q = A._split_heads(L.dense(tp.wq, tx), h, hd)
    k = A._split_heads(L.dense(tp.wk, tx), n_kv, hd)
    v = A._split_heads(L.dense(tp.wv, tx), n_kv, hd)
    cos, sin = L.rope_freqs(torch.arange(s)[None], hd)
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    k, v = A._repeat_kv(k, h), A._repeat_kv(v, h)
    heads = [t.permute(0, 2, 1, 3).reshape(h, s, hd) for t in (q, k, v)]
    o = flash_attention(*heads, causal=True, window=window, block_q=64,
                        block_k=64)
    o = o.reshape(1, h, s, hd).permute(0, 2, 1, 3).reshape(1, s, h * hd)
    got = L.dense(tp.wo, o)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=2e-4,
                               rtol=2e-4)
    assert ops.launches()["flash_attention"] == 0     # CPU: the plain version


# ------------------------------------------ the bf16 tensor-core kernel
#: one bf16 ulp of |want| (2^-8 to 2^-7 of it), plus a floor near 0: the
#: gate ``chip_smoke.py`` holds the bf16 kernel to
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4


def _tc_model(q, k, v, *, causal, window=None, block_k=64):
    """The arithmetic of the bf16 kernels (``csrc/flash_attn.cu``'s
    ``flash_fwd_bf16``, 64-key tiles, and ``csrc/flash_attn_sm90.cu``'s
    ``flash_fwd_sm90``, 64 or 128) in plain torch, fp32 out: q·k of bf16
    values in fp32 (exact products), scaled by one fp32 constant
    ``D ** -0.5 · log2(e)`` and masked to −1e30; an online softmax in base
    2 over ``block_k``-key tiles; p split into
    ``p_hi = bf16(p)`` and ``p_lo = bf16(p − p_hi)``, each multiplied by
    bf16 v in fp32, while ``l`` sums the fp32 p.  A test model, not a
    plain version: the order of each fp32 sum is torch's."""
    bh, s, d = q.shape
    t = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    c = float(np.float32(d ** -0.5 * np.log2(np.e)))
    i = torch.arange(s)[:, None]
    m = torch.full((bh, s), -1e30)
    l = torch.zeros((bh, s))
    o = torch.zeros((bh, s, d))
    for k0 in range(0, t, block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        j = torch.arange(k0, k0 + kt.shape[1])[None, :]
        x = torch.einsum("bsd,btd->bst", qf, kt) * c
        dead = torch.zeros((s, kt.shape[1]), dtype=torch.bool)
        if causal:
            dead |= j > i
        if window is not None:
            dead |= j <= i - window
        x = x.masked_fill(dead, -1e30)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + hi @ vt + lo @ vt
        m = m_new
    return o / l.clamp_min(1e-30)[..., None]


#: the sweep's shapes at bf16 (bh, s, t, d, causal, window): causal
#: blocks, windows 32 and 128, S ≠ T, head dims 16 and 120 with a window,
#: and D = 20 (not a multiple of 8)
TC_SHAPES = [(2, 256, 256, 64, True, None), (2, 512, 512, 64, True, None),
             (2, 256, 256, 32, True, 32), (2, 256, 256, 32, True, 128),
             (1, 128, 256, 64, False, None), (2, 128, 128, 16, True, 48),
             (2, 128, 128, 120, True, 48), (1, 128, 128, 20, True, None)]


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize(
    "bh,s,t,d,causal,window", TC_SHAPES,
    ids=[f"bh{b}-s{s}-t{t}-d{d}-{'causal' if c else 'full'}-w{w}"
         for b, s, t, d, c, w in TC_SHAPES])
def test_tensor_core_numerics_model(bh, s, t, d, causal, window, block_k):
    """The bf16 kernels' arithmetic (:func:`_tc_model`) meets the card's
    gates at both key tiles they use (64: ``mma_sync``, and ``wgmma`` at
    D = 256; 128: ``wgmma`` at D <= 128): rounded to bf16, within one bf16
    ulp of the plain version and within 3e-2 of the JAX reference; before
    rounding, within 2e-5 (the fp32 tolerance of these shapes) of the plain
    version on the widened inputs."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(bh, s, t, d, seed=d + s),
                                       "bfloat16")
    kw = dict(causal=causal, window=window)
    wide = _tc_model(tq, tk, tv, block_k=block_k, **kw)
    got = wide.to(torch.bfloat16).float()
    want = flash_attention_plain(tq, tk, tv, **kw).float()
    excess = (got - want).abs() - (BF16_RTOL * want.abs() + BF16_ATOL)
    assert float(excess.max()) <= 0.0
    np.testing.assert_allclose(got.numpy(), _f32(mha_ref(jq, jk, jv, **kw)),
                               atol=3e-2, rtol=3e-2)
    want_wide = flash_attention_plain(tq.float(), tk.float(), tv.float(),
                                      **kw)
    np.testing.assert_allclose(wide.numpy(), want_wide.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_wide_check_entry_on_cpu():
    """The private bf16-in, fp32-out entry: on the CPU it is the plain
    version on the widened inputs, and launches nothing."""
    from repro_torch.kernels.flash_attn import _flash_attention_wide
    tq, tk, tv = (torch.from_numpy(a).bfloat16()
                  for a in _qkv(2, 128, 128, 32, seed=3))
    got = _flash_attention_wide(tq, tk, tv, causal=True, window=48)
    want = flash_attention_plain(tq.float(), tk.float(), tv.float(),
                                 causal=True, window=48)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert ops.launches()["flash_attention"] == 0


# ------------------------------------------ the fp32 tensor-core kernel
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 (10 mantissa bits) to nearest, ties away from
    zero, on the float32 bits: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor, wide_lo: bool = False) -> tuple:
    """``hi = tf32(x)`` and ``lo = tf32(x − hi)`` (``wide_lo``: lo left at
    fp32, the widest a lo can be)."""
    hi = _tf32(x)
    return hi, (x - hi) if wide_lo else _tf32(x - hi)


def _tf32x3_model(q, k, v, *, causal, window=None, block_k=64, passes=3,
                  wide_lo=False):
    """The arithmetic of the fp32 ``wgmma`` kernel
    (``csrc/flash_attn_tf32.cu``, 64-key tiles, D in 64-column chunks) in
    plain torch: every operand split as ``hi = tf32(x)``, ``lo = tf32(x −
    hi)``; S summed chunk by chunk of D as ``Q_lo·K_hiᵀ``, then
    ``Q_hi·K_loᵀ``, then ``Q_hi·K_hiᵀ``; scaled by one fp32 constant
    ``D ** -0.5 · log2(e)`` and masked to −1e30; an online softmax in base
    2 over ``block_k``-key tiles, O rescaled, then ``P_lo·V_hi``,
    ``P_hi·V_lo``, ``P_hi·V_hi`` added in that order, while ``l`` sums the
    fp32 p.  The two variants the kernel does not take, for
    :func:`test_tf32x3_large_logits_are_order_sensitive`: ``passes=4``
    adds the ``lo·lo`` products first, ``wide_lo`` keeps every lo at fp32.
    A test model, not a plain version: the order inside each product is
    torch's."""
    bh, s, d = q.shape
    t = k.shape[1]
    c = float(np.float32(d ** -0.5 * np.log2(np.e)))
    (q_hi, q_lo), (k_hi, k_lo), (v_hi, v_lo) = (_split(x.float(), wide_lo)
                                                for x in (q, k, v))
    order = ((0, 1), (1, 0), (1, 1))       # (lo, hi), (hi, lo), (hi, hi)
    if passes == 4:
        order = ((0, 0),) + order
    i = torch.arange(s)[:, None]
    m = torch.full((bh, s), -1e30)
    l = torch.zeros((bh, s))
    o = torch.zeros((bh, s, d))
    for k0 in range(0, t, block_k):
        tile = slice(k0, k0 + block_k)
        sc = torch.zeros((bh, s, min(block_k, t - k0)))
        for c0 in range(0, d, 64):
            cols = slice(c0, c0 + 64)
            for a, b in order:
                sc = sc + ((q_lo, q_hi)[a][..., cols]
                           @ (k_lo, k_hi)[b][:, tile, cols].transpose(1, 2))
        j = torch.arange(k0, k0 + sc.shape[2])[None, :]
        dead = torch.zeros((s, sc.shape[2]), dtype=torch.bool)
        if causal:
            dead |= j > i
        if window is not None:
            dead |= j <= i - window
        x = (sc * c).masked_fill(dead, -1e30)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        p_hi, p_lo = _split(p, wide_lo)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None]
        for a, b in order:
            o = o + (p_lo, p_hi)[a] @ (v_lo, v_hi)[b][:, tile]
        m = m_new
    return o / l.clamp_min(1e-30)[..., None]


def test_tf32_split():
    """The model's rounding is ``cvt.rna``'s: ties away from zero at 2^-11
    of 1, either sign; ``hi + lo`` is x within 2^-22 of |x|."""
    one = 1.0 + 2.0 ** -11
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0, 0.0, -0.0, 2.0 ** -130])
    got = _tf32(x)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0,
                         0.0, -0.0, 2.0 ** -130])
    assert torch.equal(got, want) and got[5].view(torch.int32) < 0
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = _split(r)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -22


#: phase 7's fp32 cases at CPU size (bh, s, t, d, causal, window, logit
#: scale, tolerance): the reference test's shapes at 2e-5 (causal blocks,
#: windows 32 and 128, S ≠ T, head dims 16 and 120 with a window), a long T
#: at 1e-4 (gemma's tolerance), and D = 256 causal and with a window.  The
#: ×30 logits: :func:`test_tf32x3_large_logits_are_order_sensitive`.
TF32_CASES = [(2, 256, 256, 64, True, None, 1, 2e-5),
              (2, 512, 512, 64, True, None, 1, 2e-5),
              (2, 256, 256, 32, True, 32, 1, 2e-5),
              (2, 256, 256, 32, True, 128, 1, 2e-5),
              (1, 128, 256, 64, False, None, 1, 2e-5),
              (2, 128, 128, 16, True, 48, 1, 2e-5),
              (2, 128, 128, 120, True, 48, 1, 2e-5),
              (1, 64, 4096, 64, False, None, 1, 1e-4),
              (1, 256, 256, 256, True, None, 1, 2e-5),
              (1, 256, 256, 256, True, 100, 1, 1e-4)]


@pytest.mark.parametrize(
    "bh,s,t,d,causal,window,scale,tol", TF32_CASES,
    ids=[f"bh{b}-s{s}-t{t}-d{d}-{'causal' if c else 'full'}-w{w}-x{x}"
         for b, s, t, d, c, w, x, _ in TF32_CASES])
def test_tf32x3_numerics_model(bh, s, t, d, causal, window, scale, tol):
    """The fp32 kernel's arithmetic (:func:`_tf32x3_model`) meets the
    card's fp32 gates: within each case's tolerance of the plain version
    and of the JAX reference ``mha_ref``."""
    q, k, v = _qkv(bh, s, t, d, seed=d + s + t)
    (jq, jk, jv), (tq, tk, tv) = _both((scale * q, scale * k, v))
    kw = dict(causal=causal, window=window)
    got = _tf32x3_model(tq, tk, tv, **kw)
    want = flash_attention_plain(tq, tk, tv, block_q=s, block_k=t, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=tol)
    np.testing.assert_allclose(got.numpy(), _f32(mha_ref(jq, jk, jv, **kw)),
                               atol=tol, rtol=tol)


def _reversed_fp32(q, k, v):
    """The plain version with q·k summed over D one column at a time, last
    column first: fp32 in another summation order."""
    d = q.shape[-1]
    sc = torch.zeros((q.shape[0], q.shape[1], k.shape[1]))
    for i in reversed(range(d)):
        sc = sc + q[..., i, None] * k[..., i][:, None, :]
    dead = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool).triu(1)
    w = torch.softmax((sc * d ** -0.5).masked_fill(dead, -1e30), -1)
    return w @ v


#: the arithmetic :func:`test_tf32x3_large_logits_are_order_sensitive`
#: tries: the kernel's three TF32 passes, a fourth (``lo·lo``), and four
#: with every lo kept at fp32 (exact products in the kernel's order)
SPLITS = {"3-pass": {}, "4-pass": dict(passes=4),
          "4-pass-wide-lo": dict(passes=4, wide_lo=True)}


@pytest.mark.parametrize("d", [32, 64])
def test_tf32x3_large_logits_are_order_sensitive(d):
    """×30 logits (BH 1, S = T = 128, causal; D 32 is the reference test's
    case), over 24 inputs: at logits near 10³ the 1e-4 gate against the
    plain version holds only for q·k summed in the plain version's own
    order.  fp32 summed in reverse misses it on some inputs, and each of
    :data:`SPLITS` misses it too, as often and by as much: no fourth pass
    or wider lo rescues it.  So ``_route`` carves the reference test's
    case (D ≤ 32) out to the CUDA-core kernel, which holds it on the card;
    a larger head dim with such logits (D 64 here) takes ``tf32x3`` and
    misses the gate like reversed fp32."""
    from repro_torch.kernels.flash_attn import _route
    errs = {name: [] for name in (*SPLITS, "reversed fp32")}
    for seed in range(24):
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 128, 128, d, seed))
        q, k = 30 * q, 30 * k
        want = flash_attention_plain(q, k, v, causal=True)
        for name, kw in SPLITS.items():
            got = _tf32x3_model(q, k, v, causal=True, **kw)
            assert torch.isfinite(got).all()
            errs[name].append(float((got - want).abs().max()))
        errs["reversed fp32"].append(
            float((_reversed_fp32(q, k, v) - want).abs().max()))
    rev = errs.pop("reversed fp32")
    assert max(rev) > 1e-4                      # the gate needs the order
    for name, ours in errs.items():
        assert max(ours) > 1e-4, name           # not rescued by the split
        assert np.median(ours) <= 2 * np.median(rev), name
        assert max(ours) <= 4 * max(rev), name
    assert _route(q, k, v) == ("fp32" if d <= 32 else "tf32x3")


# ------------------------------------------------------------ routes
@pytest.mark.parametrize("d", [16, 20, 32, 36, 42, 64, 120, 128, 256])
def test_route_by_shape(d):
    """``_route`` picks the kernel from dtype, head dim and base pointers
    alone: on 16-byte aligned bases, bf16 with D % 8 == 0 takes ``wgmma``
    and fp32 with D % 4 == 0 above 32 ``tf32x3``; other bf16 inputs take
    ``mma_sync`` and other fp32 ones ``fp32``."""
    from repro_torch.kernels.flash_attn import _route
    bf = torch.zeros((2, 64, d), dtype=torch.bfloat16)
    assert _route(bf, bf, bf) == ("wgmma" if d % 8 == 0 else "mma_sync")
    f32 = torch.zeros((2, 64, d))
    assert _route(f32, f32, f32) == ("tf32x3" if d % 4 == 0 and d > 32
                                     else "fp32")
    # a view whose base is one element (2 bytes) into its storage
    off = torch.zeros(2 * 64 * d + 1, dtype=torch.bfloat16)[1:].view(2, 64, d)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    assert _route(off, bf, bf) == _route(bf, bf, off) == "mma_sync"
    # one fp32 element (4 bytes) into its storage, in any of q, k, v
    f32_off = torch.zeros(2 * 64 * d + 1)[1:].view(2, 64, d)
    assert f32_off.is_contiguous() and f32_off.data_ptr() % 16 == 4
    assert _route(f32_off, f32_off, f32_off) == "fp32"
    assert _route(f32_off, f32, f32) == _route(f32, f32, f32_off) == "fp32"


def test_tf32_scratch_size():
    """The ``tf32x3`` route's scratch: a 32 KB slot image a 64-key tile, K
    and Vᵀ, and 64-column chunk of D rounded up to 64, 128 or 256
    (``csrc/flash_attn_tf32.cu``'s ``tile_floats``)."""
    from repro_torch.kernels.flash_attn import _tf32_tiles
    assert _tf32_tiles(8, 4096, 256) * 4 == 128 * 2 ** 20
    assert _tf32_tiles(1, 1, 4) == _tf32_tiles(1, 64, 64) == 2 * 8192
    assert _tf32_tiles(2, 65, 120) == 2 * 2 * 2 * 2 * 8192
    assert _tf32_tiles(64, 1500, 64) == 64 * 24 * 2 * 8192


#: (dtype, forced route, wide) of the forced-route entry: each route of
#: each dtype and ``_route``'s own pick (None); wide (bf16 in, fp32 out)
#: only for bf16
FORCED = [(dt, route, wide) for dt, routes in
          (("bfloat16", ("wgmma", "mma_sync", None)),
           ("float32", ("tf32x3", "fp32", None)))
          for route in routes for wide in (False, True)
          if dt == "bfloat16" or not wide]


@pytest.mark.parametrize("dtype,route,wide", FORCED,
                         ids=[f"{d}-{r}-{'wide' if w else 'narrow'}"
                              for d, r, w in FORCED])
@pytest.mark.parametrize("s,t", [(128, 128), (200, 333)])
def test_forced_route_entry_on_cpu(dtype, route, wide, s, t):
    """The private entry that forces a route, either dtype: on the CPU it
    is the plain version (on the widened inputs when ``wide``), and
    launches nothing; an unknown route raises.  It takes S and T as one
    block each, as on the card, so ragged S and T pass."""
    from repro_torch.kernels.flash_attn import _flash_attention_route
    ops.reset_launches()
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in _qkv(2, s, t, 64, seed=4))
    got = _flash_attention_route(tq, tk, tv, route, causal=True, window=48,
                                 wide=wide)
    if wide:
        tq, tk, tv = tq.float(), tk.float(), tv.float()
    want = flash_attention_plain(tq, tk, tv, causal=True, window=48,
                                 block_q=s, block_k=t)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert set(ops.launches().values()) == {0}
    with pytest.raises(ValueError, match="route"):
        _flash_attention_route(tq, tk, tv, "tma", causal=True)


def test_route_counts_registered():
    """``LAUNCHES`` keeps its total and one count per route, all cleared by
    ``ops.reset_launches``."""
    from repro_torch.kernels import flash_attn as FA
    assert FA.ROUTES == ("wgmma", "mma_sync", "tf32x3", "fp32")
    assert set(FA.LAUNCHES) == {"flash_attention"} | {
        f"flash_attention[{r}]" for r in FA.ROUTES}
    FA.LAUNCHES["flash_attention[wgmma]"] = 3
    ops.reset_launches()
    assert set(ops.launches()) >= set(FA.LAUNCHES)
    assert set(FA.LAUNCHES.values()) == {0}
