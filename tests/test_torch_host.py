"""The port's host-side copies against the JAX package's originals.

The stackers and the stream-ISA compiler are numpy code the port keeps its
own copy of (it imports nothing from ``repro``).  Same inputs, same
outputs — exactly: values, dtypes, groups, permutations and program words.
"""
import numpy as np
import pytest

import repro.sparse as ref_sparse
from repro.core.compile import canonical_program as ref_canonical_program
from repro.core.precision import get_scheme as ref_get_scheme
from repro.sparse.ellpack import csr_to_ellpack as ref_csr_to_ellpack
from repro.sparse.stacking import (choose_layout as ref_choose_layout,
                                   stack_ellpack as ref_stack_ellpack,
                                   stack_rowell as ref_stack_rowell,
                                   stack_sell as ref_stack_sell)

import repro_torch.sparse as port_sparse
from repro_torch.core.compile import canonical_program
from repro_torch.core.precision import get_scheme
from repro_torch.sparse.ellpack import csr_to_ellpack
from repro_torch.sparse.stacking import (bucket_up, choose_layout,
                                         stack_ellpack, stack_rowell,
                                         stack_sell)

SCHEMES = ["fp64", "mixed_v1", "mixed_v2", "mixed_v3"]


def _bags(mod):
    """Small bags in both packages' generators: a skewed one, a uniform
    one, and one whose bucketed rows cross 2^15 (int32 indices)."""
    return {
        "skewed": [mod.powerlaw_spd(160, alpha=2.1, seed=3),
                   mod.diag_dominant_spd(90, nnz_per_row=6, dominance=1.2,
                                         seed=1),
                   mod.poisson_2d(9)],
        "uniform": [mod.poisson_2d(11), mod.tridiagonal_spd(70)],
        "int32": [mod.tridiagonal_spd(17000)],
    }


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("bag", ["skewed", "uniform", "int32"])
def test_generators_match(bag):
    for p, r in zip(_bags(port_sparse)[bag], _bags(ref_sparse)[bag]):
        _equal(p.indptr, r.indptr)
        _equal(p.indices, r.indices)
        _equal(p.data, r.data)
        assert p.shape == r.shape


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("bag", ["skewed", "uniform", "int32"])
def test_stack_rowell_and_sell_match(scheme, bag):
    port, ref = _bags(port_sparse)[bag], _bags(ref_sparse)[bag]
    sch, rsch = get_scheme(scheme), ref_get_scheme(scheme)
    p, r = stack_rowell(port, scheme=sch), ref_stack_rowell(ref, scheme=rsch)
    _equal(p.cols, r.cols)
    _equal(p.vals, r.vals)
    assert p.shapes == r.shapes and p.nnzs == r.nnzs
    p, r = stack_sell(port, scheme=sch), ref_stack_sell(ref, scheme=rsch)
    _equal(p.cols, r.cols)
    _equal(p.vals, r.vals)
    _equal(p.iperm, r.iperm)
    assert p.groups == r.groups
    assert (p.slice_rows, p.sort_window) == (r.slice_rows, r.sort_window)
    assert choose_layout(port) == ref_choose_layout(ref)


def _slice_maxima(csrs, iperm, slice_rows):
    """Per lane, per slice of the sorted rows: the widest row's nnz."""
    G, n_pad = iperm.shape
    n_slices = -(-n_pad // slice_rows)
    out = np.zeros((G, n_slices), np.int64)
    for g, a in enumerate(csrs):
        srt = np.zeros(n_slices * slice_rows, np.int64)
        srt[iperm[g, : a.shape[0]]] = a.row_nnz()
        out[g] = srt.reshape(n_slices, slice_rows).max(axis=1)
    return out


@pytest.mark.parametrize("bag", ["skewed", "uniform", "int32"])
def test_sell_lane_widths_are_slice_maxima(bag):
    """The port's one addition to ``stack_sell``: each lane's own width
    per slice, unbucketed, never above the stored (cross-lane) width;
    everything the reference also returns stays byte-identical."""
    port, ref = _bags(port_sparse)[bag], _bags(ref_sparse)[bag]
    p = stack_sell(port, scheme=get_scheme("mixed_v3"))
    r = ref_stack_sell(ref, scheme=ref_get_scheme("mixed_v3"))
    for f in ("cols", "vals", "iperm"):
        _equal(getattr(p, f), getattr(r, f))
    assert p.groups == r.groups
    assert p.lane_widths.dtype == np.int32
    want = _slice_maxima(port, p.iperm, p.slice_rows)
    assert np.array_equal(p.lane_widths, want)
    stored = np.array([w for rows, w in p.groups
                       for _ in range(-(-rows // p.slice_rows))])
    assert (p.lane_widths <= stored[None]).all()
    # the stored width is the cross-lane maximum, bucketed
    assert [bucket_up(w) if w else 0 for w in p.lane_widths.max(axis=0)] \
        == stored.tolist()
    # the serving path (a lane packed into an existing bucket) too
    one = stack_sell(port[:1], n_pad=p.padded_rows, widths=tuple(stored),
                     scheme=get_scheme("mixed_v3"))
    assert np.array_equal(one.lane_widths[0], p.lane_widths[0])


@pytest.mark.parametrize("bag", ["skewed", "uniform"])
def test_stack_ellpack_matches(bag):
    port, ref = _bags(port_sparse)[bag], _bags(ref_sparse)[bag]
    p = stack_ellpack([csr_to_ellpack(a, block_rows=32, col_tile=64)
                       for a in port])
    r = ref_stack_ellpack([ref_csr_to_ellpack(a, block_rows=32, col_tile=64)
                           for a in ref])
    for f in ("tile_cols", "vals", "local_cols"):
        _equal(getattr(p, f), getattr(r, f))
    assert (p.n_col_tiles, p.padded_rows) == (r.n_col_tiles, r.padded_rows)


def test_sell_serving_geometry_overrides_match():
    """The serving pool's ``n_pad=``/``widths=`` path packs one lane into
    an existing bucket identically."""
    port, ref = _bags(port_sparse)["skewed"], _bags(ref_sparse)["skewed"]
    base = ref_stack_sell(ref, scheme=ref_get_scheme("mixed_v3"))
    widths = tuple(w for rows, w in base.groups
                   for _ in range(rows // base.slice_rows))
    p = stack_sell(port[2:], n_pad=base.padded_rows, widths=widths,
                   scheme=get_scheme("mixed_v3"))
    r = ref_stack_sell(ref[2:], n_pad=base.padded_rows, widths=widths,
                       scheme=ref_get_scheme("mixed_v3"))
    _equal(p.cols, r.cols)
    _equal(p.vals, r.vals)
    _equal(p.iperm, r.iperm)


@pytest.mark.parametrize("policy", ["paper", "min_traffic"])
def test_canonical_program_words_identical(policy):
    _equal(canonical_program(policy), ref_canonical_program(policy))


@pytest.mark.parametrize("scheme", ["tpu_fp32", "tpu_v1", "tpu_v2",
                                    "tpu_v3"])
def test_tpu_tier_stops_at_stacking(scheme):
    """The tier no longer stops at stacking: its values pack as the
    reference's, bf16 carried as its ``uint16`` bits (the reference's
    ``astype(jnp.bfloat16)`` viewed as ``uint16``), fp32 as fp32."""
    port, ref = _bags(port_sparse)["skewed"], _bags(ref_sparse)["skewed"]
    sch, rsch = get_scheme(scheme), ref_get_scheme(scheme)
    for stack, ref_stack in ((stack_rowell, ref_stack_rowell),
                             (stack_sell, ref_stack_sell)):
        p, r = stack(port, scheme=sch), ref_stack(ref, scheme=rsch)
        want = np.asarray(r.vals)
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        _equal(p.vals, want)
        _equal(p.cols, r.cols)
