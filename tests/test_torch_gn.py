"""The port's Gauss–Newton bridge (``repro_torch.core.gn``) and CGGN
(``repro_torch.train.cggn``) against the JAX package's, on the CPU: the
same numpy inputs (and, for the LM, the reference's own parameters carried
across by ``repro_torch.convert``) go through both.

* the GGN matvec against ``repro.core.gn.make_ggn_matvec`` on the linear
  least-squares and MLP problems of ``tests/test_gn.py`` and on a reduced
  gemma3, at fp32: rtol 1e-4, atol 1e-5 (the packages sum in other
  orders); with bf16 compute: ‖Δ‖ ≤ 2e-2 ‖ref‖ (bf16 keeps 8 bits, and
  the two packages round different intermediates to it);
* the operator's symmetry and SPD-ness; the Hutchinson diagonal from the
  reference's own probe draws (rtol 1e-5);
* ``cggn_update`` against the reference's with the same parameters, batch
  and probes, at the launcher's 8 CG iterations (the MLP: rtol = atol =
  1e-4; the reduced gemma3 with the launcher's settings: atol 1e-4 on
  parameters of scale ~1).  fp32 CG grows the packages' rounding
  differences with each iteration: on the MLP ~1e-7 after 2, ~1e-5 after
  8, ~3e-4 after 10; one step of ``launch/train.cggn_lm_step`` on a VLM
  batch, whose patch embeddings must reach the model (loss rel 1e-5); a
  one-step
  solve of linear least squares to ``lstsq``'s optimum; the refresh
  cadence; monotone progress on the MLP.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401
from torch.func import functional_call

from repro.configs import get_config as ref_get_config
from repro.core import gn as RG
from repro.models import api as ref_api
from repro.train import cggn as RC

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import gn as G
from repro_torch.launch.train import cggn_lm_step
from repro_torch.train import cggn as C

ATOL, RTOL = 1e-5, 1e-4
F32 = np.float32


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(F32)


def _ref(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ---------------------------------------------------------------- problems
def _linear(seed=0, n_in=6, n_out=4, n_data=32):
    """Least squares: logits = X·W; loss = ½‖logits − Y‖² / n."""
    X, Y = _np(seed, n_data, n_in), _np(seed + 1, n_data, n_out)
    params = {"w": _np(seed + 2, n_in, n_out, scale=0.1)}
    Xj, Yj, Xt, Yt = jnp.asarray(X), jnp.asarray(Y), torch.from_numpy(X), \
        torch.from_numpy(Y)
    ref = (lambda p: Xj @ p["w"],
           lambda lg: 0.5 * jnp.sum((lg - Yj) ** 2) / n_data)
    port = (lambda p: Xt @ p["w"],
            lambda lg: 0.5 * torch.sum((lg - Yt) ** 2) / n_data)
    return params, ref, port, X, Y


def _mlp(seed=6):
    X = _np(seed, 64, 8)
    Y = np.sin(X @ _np(seed + 1, 8, 3)).astype(F32)
    params = {"w1": _np(seed + 2, 8, 16, scale=0.3),
              "w2": _np(seed + 3, 16, 3, scale=0.3)}
    Xj, Yj, Xt, Yt = jnp.asarray(X), jnp.asarray(Y), torch.from_numpy(X), \
        torch.from_numpy(Y)
    ref = (lambda p: jnp.tanh(Xj @ p["w1"]) @ p["w2"],
           lambda lg: 0.5 * jnp.mean((lg - Yj) ** 2))
    port = (lambda p: torch.tanh(Xt @ p["w1"]) @ p["w2"],
            lambda lg: 0.5 * torch.mean((lg - Yt) ** 2))
    return params, ref, port


def _ref_vag(logits_fn, loss_logits):
    return lambda p: jax.value_and_grad(
        lambda q: loss_logits(logits_fn(q)))(p)


def _port_vag(logits_fn, loss_logits):
    def vag(p):
        g, loss = torch.func.grad_and_value(
            lambda q: loss_logits(logits_fn(q)))(p)
        return loss, g
    return vag


def _lm(dtype="float32", batch=2, seq=16):
    """A reduced gemma3: the reference's parameters in both packages, a
    batch of tokens and the cross entropy in the logits."""
    cfg = dataclasses.replace(ref_get_config("gemma3-1b").reduced(),
                              dtype=dtype)
    pcfg = dataclasses.replace(get_config("gemma3-1b").reduced(),
                               dtype=dtype)
    rparams = ref_api.init_params(cfg, jax.random.PRNGKey(0))
    model = convert.lm_params_to_torch(rparams, pcfg, device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    tt, lt = torch.from_numpy(tokens).long(), torch.from_numpy(labels).long()

    def ref_logits(p):
        return ref_api.forward_logits(p, cfg, {"tokens": jnp.asarray(tokens)})

    def ref_loss(lg):
        lse = jax.nn.logsumexp(lg, axis=-1)
        picked = jnp.take_along_axis(lg, jnp.asarray(labels)[..., None],
                                     axis=-1)[..., 0]
        return jnp.mean(lse - picked)

    def port_logits(p):
        return functional_call(model, p, (tt,))

    def port_loss(lg):
        lse = torch.logsumexp(lg, dim=-1)
        return (lse - torch.gather(lg, -1, lt[..., None])[..., 0]).mean()

    return dict(cfg=cfg, pcfg=pcfg, rparams=rparams, model=model,
                ref=(ref_logits, ref_loss), port=(port_logits, port_loss),
                batch={"tokens": tt, "labels": lt})


# ---------------------------------------------------------------- flatten
def test_flatten_roundtrip_views_and_order():
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}}
    flat, ravel, unravel = G.flatten_like(tree)
    assert flat.shape == (10,)
    # a mapping in sorted key order ravels as jax.tree_util orders it
    want, _, _ = RG.flatten_like({"b": {"c": jnp.ones(4)},
                                  "a": jnp.arange(6.0).reshape(2, 3)})
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = unravel(flat)
    assert list(back) == ["a", "b.c"]
    assert list(G.param_dict({"b": {"c": 1}, "a": 2})) == ["b.c", "a"]
    for name, t in back.items():
        assert t.data_ptr() >= flat.data_ptr()      # views, no copies
        assert t._base is flat
    torch.testing.assert_close(back["a"], tree["a"], rtol=0, atol=0)
    torch.testing.assert_close(ravel(back), flat, rtol=0, atol=0)


def test_flatten_module_order_is_named_parameters():
    model = convert.lm_params_to_torch(
        ref_api.init_params(ref_get_config("gemma3-1b").reduced(),
                            jax.random.PRNGKey(0)),
        get_config("gemma3-1b").reduced(), device="cpu")
    flat, _, unravel = G.flatten_like(model)
    assert list(unravel(flat)) == [n for n, _ in model.named_parameters()]
    assert flat.numel() == sum(p.numel() for p in model.parameters())


# ------------------------------------------------------------- GGN matvec
@pytest.mark.parametrize("problem", ["linear", "mlp"])
def test_ggn_matvec_matches_reference(problem):
    params, ref, port = (_linear()[:3] if problem == "linear" else _mlp())
    mv_r, n = RG.make_ggn_matvec(ref[1], ref[0], _ref(params), 1e-3)
    mv_p, n_p = G.make_ggn_matvec(port[1], port[0], _port(params), 1e-3)
    assert n_p == n
    for seed in range(3):
        v = _np(10 + seed, n)
        np.testing.assert_allclose(mv_p(torch.from_numpy(v)).numpy(),
                                   np.asarray(mv_r(jnp.asarray(v))),
                                   rtol=RTOL, atol=ATOL)


def test_ggn_matvec_linear_is_explicit_ggn():
    params, _, port, X, _ = _linear()
    mv, n = G.make_ggn_matvec(port[1], port[0], _port(params), 1e-3)
    Gm = np.kron(X.T.astype(np.float64) @ X / 32, np.eye(4))
    v = _np(4, n)
    np.testing.assert_allclose(mv(torch.from_numpy(v)).numpy(),
                               Gm @ v + 1e-3 * v, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ggn_matvec_lm_matches_reference(dtype):
    lm = _lm(dtype)
    mv_r, n = RG.make_ggn_matvec(lm["ref"][1], lm["ref"][0], lm["rparams"],
                                 1e-3)
    mv_p, n_p = G.make_ggn_matvec(lm["port"][1], lm["port"][0], lm["model"],
                                  1e-3)
    assert n_p == n
    v = _np(5, n, scale=0.1)
    want = np.asarray(mv_r(jnp.asarray(v)))
    got = convert.lm_flat_from_torch(
        mv_p(convert.lm_flat_to_torch(v, lm["pcfg"], device="cpu")),
        lm["pcfg"])
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


def _dense_operator(mv, n):
    return np.stack([mv(torch.eye(n)[i]).numpy() for i in range(n)])


@pytest.mark.parametrize("problem", ["linear", "mlp"])
def test_ggn_operator_symmetric_positive_definite(problem):
    params, _, port = (_linear(1)[:3] if problem == "linear" else _mlp())
    mv, n = G.make_ggn_matvec(port[1], port[0], _port(params), 1e-3)
    M = _dense_operator(mv, n)
    np.testing.assert_allclose(M, M.T, atol=1e-5)
    assert np.linalg.eigvalsh(M.astype(np.float64)).min() > 0


def _ref_draws(key, n, probes):
    return [np.asarray(jax.random.rademacher(k, (n,), dtype=jnp.float32))
            for k in jax.random.split(key, probes)]


def _substitute_draws(monkeypatch, draws):
    """Make the port's probes the given vectors, in order."""
    it = iter(draws)
    monkeypatch.setattr(G, "_rademacher",
                        lambda n, gen, dtype: torch.as_tensor(
                            np.array(next(it))).to(dtype))


def test_rademacher_draws_signs():
    e = G._rademacher(10_000, torch.Generator().manual_seed(0),
                      torch.float32)
    assert set(np.unique(e.numpy())) == {-1.0, 1.0}
    assert abs(float(e.mean())) < 0.05


def test_hutchinson_diag_from_reference_draws(monkeypatch):
    params, ref, port, *_ = _linear(2)
    mv_r, n = RG.make_ggn_matvec(ref[1], ref[0], _ref(params), 1e-3)
    mv_p, _ = G.make_ggn_matvec(port[1], port[0], _port(params), 1e-3)
    key = jax.random.PRNGKey(3)
    want = np.asarray(RG.estimate_jacobi_diag(mv_r, n, key, probes=16))
    _substitute_draws(monkeypatch, _ref_draws(key, n, 16))
    got = G.estimate_jacobi_diag(mv_p, n, torch.Generator(), probes=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    # and, with the port's own draws, near the exact diagonal
    monkeypatch.undo()
    est = G.estimate_jacobi_diag(mv_p, n, torch.Generator().manual_seed(3),
                                 probes=256).numpy()
    np.testing.assert_allclose(est, np.diag(_dense_operator(mv_p, n)),
                               rtol=0.5)
    assert est.min() > 0


# ------------------------------------------------------------------- CGGN
def _cggn_draws(key, n, probes):
    """The probes the reference's ``cggn_update`` draws from ``key``."""
    _, sub = jax.random.split(key)
    return _ref_draws(sub, n, probes)


def test_cggn_update_matches_reference_mlp(monkeypatch):
    params, ref, port = _mlp()
    cfg = dict(lr=1.0, damping=1e-2, cg_iters=8, probes=4,
               scheme="tpu_fp32")
    key = jax.random.PRNGKey(8)
    st = RC.cggn_init(_ref(params), key)
    p_r, st_r, m_r = RC.cggn_update(
        _ref(params), st, loss_logits_fn=ref[1], logits_fn=ref[0],
        loss_value_and_grad=_ref_vag(*ref), cfg=RC.CGGNConfig(**cfg))
    n = int(st.diag.shape[0])
    _substitute_draws(monkeypatch, _cggn_draws(key, n, 4))
    pp = _port(params)
    st_p = convert.cggn_state_to_torch(st, device="cpu")
    assert st_p.seed == 8 and st_p.step == 0
    p_p, st_p, m_p = C.cggn_update(
        pp, st_p, loss_logits_fn=port[1], logits_fn=port[0],
        loss_value_and_grad=_port_vag(*port), cfg=C.CGGNConfig(**cfg))
    assert p_p is pp and st_p.step == 1
    for k in params:
        np.testing.assert_allclose(p_p[k].numpy(), np.asarray(p_r[k]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st_p.diag.numpy(), np.asarray(st_r.diag),
                               rtol=1e-5, atol=1e-7)
    for k in ("loss", "delta_norm", "grad_norm"):
        assert float(m_p[k]) == pytest.approx(float(m_r[k]), rel=1e-4)
    assert 1 <= m_p["cg_iters"] <= 8          # on-the-fly termination


def test_cggn_update_matches_reference_lm(monkeypatch):
    """The launcher's settings (cg_iters 8, tpu_fp32, 4 probes) on a
    reduced gemma3 at fp32; the trust region rescales δ to 10."""
    lm = _lm()
    ccfg = dict(cg_iters=8, scheme="tpu_fp32", lr=1.0)
    key = jax.random.PRNGKey(0)
    st = RC.cggn_init(lm["rparams"], key)
    p_r, _, m_r = RC.cggn_update(
        lm["rparams"], st, loss_logits_fn=lm["ref"][1],
        logits_fn=lm["ref"][0], loss_value_and_grad=_ref_vag(*lm["ref"]),
        cfg=RC.CGGNConfig(**ccfg))
    n = int(st.diag.shape[0])
    _substitute_draws(monkeypatch, [
        convert.lm_flat_to_torch(d, lm["pcfg"], device="cpu")
        for d in _cggn_draws(key, n, 4)])
    st_p = convert.cggn_state_to_torch(st, lm["pcfg"], device="cpu")
    model, st_p, m_p = cggn_lm_step(lm["model"], st_p, lm["batch"],
                                    C.CGGNConfig(**ccfg))
    got = convert.lm_params_from_torch(model, lm["pcfg"])
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(p_r)[0]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0,
                                   err_msg=str(path))
    for k in ("loss", "delta_norm", "grad_norm"):
        assert float(m_p[k]) == pytest.approx(float(m_r[k]), rel=1e-4)
    assert 1 <= m_p["cg_iters"] <= 8          # on-the-fly termination


def test_cggn_lm_step_feeds_patch_embeds(monkeypatch):
    """``launch/train.cggn_lm_step`` on a VLM batch (the reduced
    internvl2-76b, random ``patch_embeds``) optimizes the reference's
    function: its ``logits_fn`` is ``forward_logits(p, cfg, batch)``, so
    the patch embeddings reach the model (dropping them gave a loss of
    64.595 against 75.349).  The loss within rel 1e-5, ‖δ‖ and ‖g‖ within
    rel 1e-4, the parameters within atol 1e-4."""
    rc = ref_get_config("internvl2-76b").reduced()
    pc = get_config("internvl2-76b").reduced()
    rparams = ref_api.init_params(rc, jax.random.PRNGKey(0))
    model = convert.lm_params_to_torch(rparams, pc, device="cpu")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, rc.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, rc.vocab, (2, 16)).astype(np.int32)
    patches = _np(5, 2, rc.n_patches, rc.d_model)
    rbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
              "patch_embeds": jnp.asarray(patches)}
    pbatch = {"tokens": torch.from_numpy(tokens).long(),
              "labels": torch.from_numpy(labels).long(),
              "patch_embeds": torch.from_numpy(patches)}

    def ref_logits(p):
        return ref_api.forward_logits(p, rc, rbatch)

    def ref_loss(lg):
        lse = jax.nn.logsumexp(lg, axis=-1)
        return jnp.mean(lse - jnp.take_along_axis(
            lg, rbatch["labels"][..., None], axis=-1)[..., 0])

    ccfg = dict(cg_iters=8, scheme="tpu_fp32", lr=1.0)
    key = jax.random.PRNGKey(0)
    st = RC.cggn_init(rparams, key)
    p_r, _, m_r = RC.cggn_update(
        rparams, st, loss_logits_fn=ref_loss, logits_fn=ref_logits,
        loss_value_and_grad=_ref_vag(ref_logits, ref_loss),
        cfg=RC.CGGNConfig(**ccfg))
    assert float(m_r["loss"]) == pytest.approx(
        float(ref_api.loss_fn(rparams, rc, rbatch)), rel=1e-6)
    _substitute_draws(monkeypatch, [
        convert.lm_flat_to_torch(d, pc, device="cpu")
        for d in _cggn_draws(key, int(st.diag.shape[0]), 4)])
    st_p = convert.cggn_state_to_torch(st, pc, device="cpu")
    model, st_p, m_p = cggn_lm_step(model, st_p, pbatch,
                                    C.CGGNConfig(**ccfg))
    assert float(m_p["loss"]) == pytest.approx(float(m_r["loss"]), rel=1e-5)
    for k in ("delta_norm", "grad_norm"):
        assert float(m_p[k]) == pytest.approx(float(m_r[k]), rel=1e-4)
    got = convert.lm_params_from_torch(model, pc)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(p_r)[0]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0,
                                   err_msg=str(path))


def test_one_step_solves_linear_least_squares():
    """GN == Newton on quadratics: one CGGN step with enough CG
    iterations lands at the optimum."""
    params, _, port, X, Y = _linear(4)
    cfg = C.CGGNConfig(lr=1.0, damping=1e-6, cg_iters=200, cg_tol=1e-18,
                       probes=8, scheme="tpu_fp32")
    p = _port(params)
    p1, _, _ = C.cggn_update(p, C.cggn_init(p, 5), loss_logits_fn=port[1],
                             logits_fn=port[0],
                             loss_value_and_grad=_port_vag(*port), cfg=cfg)
    w_star = np.linalg.lstsq(X.astype(np.float64), Y.astype(np.float64),
                             rcond=None)[0]
    np.testing.assert_allclose(p1["w"].numpy(), w_star, rtol=1e-2,
                               atol=1e-3)


def test_loss_decreases_on_mlp():
    params, _, port = _mlp()
    cfg = C.CGGNConfig(lr=1.0, damping=1e-2, cg_iters=30, scheme="tpu_fp32")
    p = _port(params)
    st = C.cggn_init(p, 8)
    losses = []
    for _ in range(5):
        p, st, m = C.cggn_update(p, st, loss_logits_fn=port[1],
                                 logits_fn=port[0],
                                 loss_value_and_grad=_port_vag(*port),
                                 cfg=cfg)
        losses.append(float(m["loss"]))
        assert float(m["delta_norm"]) <= cfg.max_delta_norm * (1 + 1e-6)
    assert losses[-1] < losses[0] * 0.5, losses


def test_precond_refresh_cadence():
    params, _, port, *_ = _linear(9)
    cfg = C.CGGNConfig(refresh_precond=2, cg_iters=5, scheme="tpu_fp32")
    p = _port(params)
    kw = dict(loss_logits_fn=port[1], logits_fn=port[0],
              loss_value_and_grad=_port_vag(*port), cfg=cfg)
    st0 = C.cggn_init(p, 10)
    _, st1, _ = C.cggn_update(p, st0, **kw)
    assert not torch.allclose(st1.diag, torch.ones_like(st1.diag))
    _, st2, _ = C.cggn_update(p, st1, **kw)          # step 1: cached
    assert st2.diag is st1.diag
    _, st3, _ = C.cggn_update(p, st2, **kw)          # step 2: refreshed
    assert st3.diag is not st2.diag and st3.step == 3
