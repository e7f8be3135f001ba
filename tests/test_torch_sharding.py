"""The port's sharding rules against the reference's, on the CPU.

* ``param_specs`` of every config at full size (the port's model built on
  ``meta``, the reference's from ``jax.eval_shape``) equals the
  reference's, each stacked leaf's spec without its leading layer entry,
  with no mesh and on the 16×16 and 2×16×16 production meshes (duck-typed:
  the reference's ``_fit``, ``data_axes`` and ``cache_specs`` read only
  ``mesh.shape`` and ``mesh.axis_names``);
* ``batch_specs`` of every cell's inputs, ``cache_specs`` at batch 128
  and 1, and ``activation_spec`` equal the reference's;
* ``placements`` give each mesh coordinate the block of a sharded dim that
  JAX's major-to-minor order gives it (DTensor's local offsets, computed
  for every coordinate of both meshes), and refuse what DTensor cannot
  nest;
* the solver's mesh names: ``core.shard.lane_sharding`` indexes the
  blocks ``place_lanes`` cuts, and ``cg_dist.AXIS`` is the reference's.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest

from repro.configs import (ARCHS as REF_ARCHS, get_config as ref_get_config,
                           input_specs as ref_input_specs)
from repro.distributed import sharding as RS
from repro.models import api as ref_api

from repro_torch.configs import ARCHS, SHAPES, applicable, get_config, \
    input_specs
from repro_torch.distributed import sharding as S
from repro_torch.models import api


class FakeMesh:
    """The reference's ``Mesh`` as its rules read it."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


MESHES = {"none": None,
          "single": FakeMesh((16, 16), ("data", "model")),
          "multi": FakeMesh((2, 16, 16), ("pod", "data", "model"))}
STACKS = ("layers", "enc_layers", "dec_layers")


def _ref_flat(tree):
    return {tuple(str(getattr(k, "key", getattr(k, "name", k)))
                  for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


@pytest.fixture(scope="module")
def shapes():
    """{arch: (reference param shapes, port meta module)}"""
    out = {}
    for arch in ARCHS:
        rc, pc = ref_get_config(arch), get_config(arch)
        rshape = jax.eval_shape(lambda k: ref_api.init_params(rc, k),
                                jax.random.PRNGKey(0))
        out[arch] = (rshape, api.model_class(pc)(pc, device="meta"))
    return out


def test_same_archs():
    assert sorted(ARCHS) == sorted(REF_ARCHS)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_match_reference(shapes, arch, mesh):
    rshape, module = shapes[arch]
    want = _ref_flat(RS.param_specs(rshape, MESHES[mesh]))
    leaves = _ref_flat(rshape)
    got = S.param_specs(module, MESHES[mesh])
    checked = set()
    for path, spec in want.items():
        spec = tuple(spec)
        if path[0] in STACKS:
            assert spec[0] is None, path
            for l in range(leaves[path].shape[0]):
                name = f"{path[0]}.{l}.{'.'.join(path[1:])}"
                assert got[name] == spec[1:], (name, got[name], spec)
                checked.add(name)
        else:
            assert got[".".join(path)] == spec, path
            checked.add(".".join(path))
    assert checked == set(got)          # every port parameter was checked


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_take_shapes(shapes, arch):
    """A ``{name: shape}`` mapping gives the module's specs."""
    _, module = shapes[arch]
    mesh = MESHES["multi"]
    by_shape = {n: tuple(p.shape) for n, p in module.named_parameters()}
    assert S.param_specs(by_shape, mesh) == S.param_specs(module, mesh)


def _cells():
    for arch in ARCHS:
        for shape in SHAPES:
            if applicable(get_config(arch), SHAPES[shape])[0]:
                yield arch, shape


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch,shape", [c for c in _cells()
                                        if SHAPES[c[1]].kind != "decode"])
def test_batch_specs_match_reference(arch, shape, mesh):
    m = MESHES[mesh]
    want = {k: tuple(v) for k, v in
            RS.batch_specs(ref_input_specs(arch, shape), m).items()}
    assert S.batch_specs(input_specs(arch, shape), m) == want


@pytest.mark.parametrize("batch", [128, 1])
@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_specs_match_reference(arch, mesh, batch):
    m = MESHES[mesh]
    rc, pc = ref_get_config(arch), get_config(arch)
    length = 32_768
    rcache = jax.eval_shape(lambda: ref_api.init_cache(rc, batch, length))
    want = {k: tuple(v) for k, v in
            _ref_flat(RS.cache_specs(rcache, m, batch=batch)).items()}
    got = {}
    _collect_specs(S.cache_specs(api.init_cache(pc, batch, length,
                                                device="meta"),
                                 m, batch=batch), got)
    assert got == want


def _collect_specs(tree, out, names=()):
    if S.is_spec(tree):
        out[names] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _collect_specs(v, out, names + (k,))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _collect_specs(getattr(tree, f.name), out, names + (f.name,))


@pytest.mark.parametrize("seq", [4_096, 8_192, 32_768, 524_288, 8_200])
@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_activation_spec_matches_reference(mesh, seq):
    m = MESHES[mesh]
    assert S.activation_spec(m, seq) == tuple(RS.activation_spec(m, seq))
    assert S.data_axes(m) == RS.data_axes(m)


# ------------------------------------------------------------ placements
def _jax_block(spec, axes, sizes, coord, dim):
    """The [start, stop) of tensor dim ``dim`` that JAX gives the mesh
    coordinate ``coord``: the entry's axes index the dim's blocks
    major to minor."""
    entry = spec[dim]
    names = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    n = int(np.prod([sizes[a] for a in names])) if names else 1
    idx = np.ravel_multi_index(tuple(coord[axes.index(a)] for a in names),
                               tuple(sizes[a] for a in names)) \
        if names else 0
    return idx, n


SPECS = [("data", "model"), ("model", "data"), (("data", "model"), None),
         (("pod", "data"), "model"), (None, ("pod", "data", "model")),
         ("pod", None)]


def _axes_of(spec):
    return {a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}


@pytest.mark.parametrize("mesh,spec", [
    (mesh, spec) for mesh in ("single", "multi") for spec in SPECS
    if _axes_of(spec) <= set(MESHES[mesh].axis_names)])
def test_placements_give_jax_blocks(mesh, spec):
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as local_of
    m = MESHES[mesh]
    axes = m.axis_names
    sizes = m.shape
    shape = (1024, 512)
    pl = S.placements(spec, m)
    for coord in itertools.product(*(range(sizes[a]) for a in axes)):
        lshape, offset = local_of(shape, tuple(sizes[a] for a in axes),
                                  list(coord), pl)
        for d in range(2):
            idx, n = _jax_block(spec, axes, sizes, coord, d)
            blk = shape[d] // n
            assert (offset[d], lshape[d]) == (idx * blk, blk), \
                (spec, coord, d)


def test_placements_refuse_what_dtensor_cannot_nest():
    m = MESHES["multi"]
    with pytest.raises(ValueError, match="order"):
        S.placements((("data", "pod"), None), m)
    with pytest.raises(ValueError, match="twice"):
        S.placements(("data", "data"), m)


def test_named_shardings_keep_structure():
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["single"]
    sh = S.named_shardings({"a": ("data", None), "b": (None, "model"),
                            "c": ()}, m)
    assert sh["a"].placements == (Shard(0), Replicate())
    assert sh["b"].placements == (Replicate(), Shard(1))
    assert sh["c"].placements == (Replicate(), Replicate())
    mesh, pl = sh["a"]
    assert mesh is m


# ------------------------------------------------------- the solver's names
@pytest.mark.parametrize("lane_axis", [0, 1])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_lane_sharding_is_the_partition_place_lanes_cuts(d, lane_axis):
    import torch
    from repro_torch.core.shard import lane_sharding, place_lanes
    mesh = ("cpu",) * d
    x = torch.arange(3 * 8 * 5).reshape(3, 8, 5).movedim(1, lane_axis)
    sh = lane_sharding(mesh, x.ndim, lane_axis)
    idx = sh.shard_indices(tuple(x.shape))
    pieces = place_lanes(mesh, x, lane_axis=lane_axis)
    assert len(idx) == len(pieces) == d
    for i, piece in zip(idx, pieces):
        assert torch.equal(x[i], piece)
    with pytest.raises(ValueError):
        sh.shard_indices((8,))


def test_row_axis_name_is_the_reference_s():
    from repro.distributed import cg_dist as ref_cg_dist
    from repro_torch.distributed import cg_dist
    assert cg_dist.AXIS == ref_cg_dist.AXIS == "rows"
