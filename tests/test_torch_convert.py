"""State carried across: a JAX VM state stepped a few chunks, converted
with :mod:`repro_torch.convert` and continued in the port, ends where the
JAX engine ends — same statuses, iterations within ±1, ``x`` within
``rtol=1e-4, atol=1e-6`` (the port's row dots reduce in another order, so
the continuation is not bitwise).

The training side, bit for bit: the LM parameters there and back
(``lm_params_to_torch`` / ``lm_params_from_torch``), a flat
parameter-space vector between the two orders, and the optimizer states
(``adamw_state_to_torch`` with bf16 moments, ``cggn_state_to_torch``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

import repro.sparse as ref_sparse
from repro.core.batch import _matvec_factory as ref_matvec_factory
from repro.core.compile import canonical_program as ref_canonical_program
from repro.core.precision import get_scheme as ref_get_scheme
from repro.core.vm import make_vm_stepper as ref_make_vm_stepper
from repro.core.vm import vm_init as ref_vm_init
from repro.sparse.ellpack import csr_to_ellpack as ref_csr_to_ellpack
from repro.sparse.stacking import (stack_ellpack as ref_stack_ellpack,
                                   stack_rowell as ref_stack_rowell,
                                   stack_sell as ref_stack_sell)

from repro_torch import convert
from repro_torch.core.compile import canonical_program
from repro_torch.core.precision import get_scheme
from repro_torch.core.vm import make_vm_stepper

CHUNK = 4


def _bag():
    return [ref_sparse.poisson_2d(9),
            ref_sparse.diag_dominant_spd(100, nnz_per_row=6, dominance=1.3,
                                         seed=2),
            ref_sparse.powerlaw_spd(150, alpha=2.1, seed=3)]


def _reference_setup(layout, rsch):
    """The JAX side: stacked bag, warm-up state and a stepper."""
    bag = _bag()
    kw = dict(layout=layout, groups=None, col_tile=None, n_col_tiles=None)
    if layout == "sell":
        st = ref_stack_sell(bag, scheme=rsch)
        mat = (jnp.asarray(st.cols), jnp.asarray(st.vals),
               jnp.asarray(st.iperm))
        kw.update(backend="xla", groups=st.groups)
        bucket = (st.padded_rows, *(d for rw in st.groups for d in rw))
        n_pad, index_bytes = st.padded_rows, st.index_bytes
    elif layout == "rowell":
        st = ref_stack_rowell(bag, scheme=rsch)
        mat = (jnp.asarray(st.cols), jnp.asarray(st.vals))
        kw.update(backend="xla")
        bucket, n_pad = (st.padded_rows, st.width), st.padded_rows
        index_bytes = st.index_bytes
    else:
        st = ref_stack_ellpack([ref_csr_to_ellpack(a, block_rows=128,
                                                   col_tile=128)
                                for a in bag])
        mat = (jnp.asarray(st.tile_cols),
               jnp.asarray(st.vals).astype(rsch.matrix_dtype),
               jnp.asarray(st.local_cols))
        kw.update(backend="pallas", col_tile=128, n_col_tiles=st.n_col_tiles)
        bucket, n_pad = st.vals.shape[1:], st.padded_rows
        index_bytes = 4
    G = len(bag)

    def pad(vecs, fill):
        out = np.full((G, n_pad), fill)
        for g, v in enumerate(vecs):
            out[g, : v.shape[0]] = v
        return jnp.asarray(out)

    diag = pad([a.diagonal() for a in bag], 1.0)
    b = pad([np.ones(a.shape[0]) for a in bag], 0.0)
    x0 = pad([np.zeros(a.shape[0]) for a in bag], 0.0)
    tol = jnp.full(G, 1e-12)
    extra = dict(interpret=True) if layout == "ellpack" else {}
    matvec = ref_matvec_factory(scheme=rsch, **kw, **extra)(mat)
    st0 = ref_vm_init(matvec, diag, b, x0, maxiter=0, with_trace=False,
                      tol=tol)
    stepper = ref_make_vm_stepper(
        scheme=rsch, bucket=bucket, chunk=CHUNK, index_bytes=index_bytes,
        steps_per_sync=1, program=ref_canonical_program("paper"), **kw,
        **extra)
    return st, mat, st0, tol, stepper, kw, bucket, index_bytes


@pytest.mark.parametrize("layout", ["rowell", "sell", "ellpack"])
@pytest.mark.parametrize("scheme", ["fp64", "mixed_v3"])
def test_jax_state_continues_in_port(scheme, layout):
    sch, rsch = get_scheme(scheme), ref_get_scheme(scheme)
    stacked, mat, st0, tol, stepper, kw, bucket, index_bytes = \
        _reference_setup(layout, rsch)
    maxiter_vec = jnp.full(tol.shape[0], 400, jnp.int32)
    mid = stepper(mat, st0, tol, maxiter_vec)          # a few JAX chunks
    mid = stepper(mat, mid, tol, maxiter_vec)
    assert int(mid.k) == 2 * CHUNK

    ref = mid
    while bool(np.asarray(ref.active).any()):
        ref = stepper(mat, ref, tol, maxiter_vec)

    t_mat = convert.stacked_to_torch(stacked, scheme=sch, device="cpu")
    t_state = convert.vm_state_to_torch(mid, device="cpu")
    snap = convert.vm_state_to_numpy(t_state)
    for f in t_state._fields:                          # exact round trip
        assert np.array_equal(snap[f], np.asarray(getattr(mid, f)))
    t_step = make_vm_stepper(
        scheme=sch, bucket=bucket, chunk=CHUNK, index_bytes=index_bytes,
        program=canonical_program("paper"), **kw)
    t_tol = torch.from_numpy(np.array(tol))
    t_maxiter = torch.from_numpy(np.array(maxiter_vec))
    while bool(t_state.active.any()):
        t_state = t_step(t_mat, t_state, t_tol, t_maxiter)

    got = convert.vm_state_to_numpy(t_state)
    want = {f: np.asarray(getattr(ref, f)) for f in t_state._fields}
    assert np.array_equal(got["status"], want["status"])
    assert np.all(np.abs(got["it"] - want["it"]) <= 1)
    np.testing.assert_allclose(got["mem"][0], want["mem"][0], rtol=1e-4,
                               atol=1e-6)


# ------------------------------------------------------------- training
def _ref_lm():
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.models import init_params as ref_init_params
    from repro_torch.configs import get_config
    cfg = get_config("gemma3-1b").reduced()
    return ref_init_params(ref_get_config("gemma3-1b").reduced(),
                           jax.random.PRNGKey(0)), cfg


def test_lm_params_round_trip():
    import jax
    rp, cfg = _ref_lm()
    back = convert.lm_params_from_torch(
        convert.lm_params_to_torch(rp, cfg, device="cpu"), cfg)
    want = jax.tree_util.tree_flatten_with_path(rp)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_lm_flat_vector_round_trip():
    from repro.core.gn import flatten_like as ref_flatten_like
    from repro_torch.core.gn import flatten_like
    rp, cfg = _ref_lm()
    ref_flat = np.asarray(ref_flatten_like(rp)[0])
    model = convert.lm_params_to_torch(rp, cfg, device="cpu")
    port_flat = convert.lm_flat_to_torch(ref_flat, cfg, device="cpu")
    # the reference's ravel, reordered, is the port's ravel of the module
    assert torch.equal(port_flat, flatten_like(model)[0])
    np.testing.assert_array_equal(convert.lm_flat_from_torch(port_flat, cfg),
                                  ref_flat)


@pytest.mark.parametrize("lm", [False, True], ids=["dict", "lm"])
def test_adamw_state_to_torch(lm):
    import jax
    from repro.train.optim import AdamWConfig as RefAdamWConfig
    from repro.train.optim import adamw_init as ref_adamw_init
    from repro_torch.core.gn import param_dict
    if lm:
        rp, cfg = _ref_lm()
    else:
        rp, cfg = {"b": jnp.ones(3), "w": {"k": jnp.ones((2, 3))}}, None
    st = ref_adamw_init(rp, RefAdamWConfig())
    rng = np.random.default_rng(0)
    st = st._replace(step=jnp.asarray(7, jnp.int32),
                     m=jax.tree_util.tree_map(lambda a: jnp.asarray(
                         rng.standard_normal(a.shape), jnp.bfloat16), st.m),
                     v=jax.tree_util.tree_map(lambda a: jnp.asarray(
                         rng.random(a.shape), jnp.bfloat16), st.v))
    pst = convert.adamw_state_to_torch(st, cfg, device="cpu")
    assert pst.step.dtype == torch.int32 and int(pst.step) == 7
    if lm:
        names = [n for n, _ in convert.lm_params_to_torch(
            rp, cfg, device="cpu").named_parameters()]
        assert sorted(pst.m) == sorted(names)
        back = {"m": convert.lm_params_from_torch(pst.m, cfg),
                "v": convert.lm_params_from_torch(pst.v, cfg)}
    else:
        assert list(pst.m) == list(param_dict({"b": 0, "w": {"k": 0}}))
        back = {"m": {"b": convert._host(pst.m["b"]),
                      "w": {"k": convert._host(pst.m["w.k"])}},
                "v": {"b": convert._host(pst.v["b"]),
                      "w": {"k": convert._host(pst.v["w.k"])}}}
    for k in ("m", "v"):
        assert all(t.dtype == torch.bfloat16 for t in getattr(pst, k).values())
        for a, b in zip(jax.tree_util.tree_leaves(back[k]),
                        jax.tree_util.tree_leaves(getattr(st, k))):
            np.testing.assert_array_equal(a, np.asarray(b).view(np.uint16))


@pytest.mark.parametrize("seed", [0, 5, 2**32 - 1])
def test_cggn_state_to_torch(seed):
    import jax
    from repro.train.cggn import cggn_init as ref_cggn_init
    rp, cfg = _ref_lm()
    st = ref_cggn_init(rp, jax.random.PRNGKey(seed))
    n = int(st.diag.shape[0])
    st = st._replace(step=jnp.asarray(3, jnp.int32), diag=jnp.asarray(
        np.random.default_rng(1).random(n), jnp.float32))
    pst = convert.cggn_state_to_torch(st, cfg, device="cpu")
    assert pst.step == 3 and pst.seed == seed
    np.testing.assert_array_equal(convert.lm_flat_from_torch(pst.diag, cfg),
                                  np.asarray(st.diag))
    flat = convert.cggn_state_to_torch(st, device="cpu")
    np.testing.assert_array_equal(flat.diag.numpy(), np.asarray(st.diag))
