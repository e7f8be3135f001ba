"""The port's activation hints: the reference's five hint tests
(tests/test_hints.py), on a ``DeviceMesh`` over a gloo process group of
world size 1 (started here, in this process, with a ``file://``
rendezvous, and destroyed after), plus what DTensor adds: a hint
redistributes a DTensor and returns a plain tensor as it is; and
``make_mesh`` refuses a shape the running group cannot hold."""
import datetime

import pytest
import torch
from _torch_pin import one_thread  # noqa: F401
import torch.distributed as dist

from repro_torch.distributed import hints
from repro_torch.launch.mesh import make_mesh


@pytest.fixture(scope="module")
def pg(tmp_path_factory):
    path = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _dt(x, mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    return distribute_tensor(x, mesh, [Replicate()] * mesh.ndim)


def test_noop_without_context():
    x = torch.ones(4, 8)
    y = hints.hint(x, hints.DATA, hints.MODEL)
    assert y is x                      # literally untouched


def test_resolution_single_device(pg):
    from torch.distributed.tensor import DTensor, Shard
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    with hints.sharding_hints(mesh):
        assert hints.active_mesh() is mesh
        x = _dt(torch.arange(8.0).reshape(2, 4), mesh)
        y = hints.hint(x, hints.DATA, hints.MODEL)
        assert isinstance(y, DTensor)
        assert y.placements == (Shard(0), Shard(1))
        assert torch.equal(y.full_tensor(), x.full_tensor())
        plain = torch.ones(2, 4)
        assert hints.hint(plain, hints.DATA, hints.MODEL) is plain
    assert hints.active_mesh() is None


def test_missing_axes_dropped(pg):
    mesh = make_mesh((1,), ("rows",), device_type="cpu")
    with hints.sharding_hints(mesh):
        x = _dt(torch.ones(4, 4), mesh)
        y = hints.hint(x, hints.DATA, hints.MODEL)
        assert y is x                  # all entries resolved to None


def test_context_nesting_restores(pg):
    mesh = make_mesh((1,), ("rows",), device_type="cpu")
    with hints.sharding_hints(mesh):
        with hints.sharding_hints(None):
            assert hints.active_mesh() is None
        assert hints.active_mesh() is mesh


def test_hint_inside_jit_traces(pg):
    """A hint inside a function traced by ``torch.compile`` (the eager
    backend: no C++ compiler needed), as the reference's runs under
    ``jax.jit``."""
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")

    def f(x):
        return hints.hint(x, hints.DATA, None) * 2.0

    with hints.sharding_hints(mesh):
        y = torch.compile(f, backend="eager", fullgraph=False)(
            _dt(torch.ones(2, 2), mesh))
    assert torch.equal(y.full_tensor(), torch.full((2, 2), 2.0))


def test_make_mesh_needs_a_group_of_its_size(pg):
    """A mesh is built over the running group; another size raises (the
    production meshes need 256 and 512 ranks)."""
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="world size 4"):
        make_mesh((2, 2), ("data", "model"), device_type="cpu")
    with pytest.raises(RuntimeError, match="world size 512"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((1, 1), ("data",), device_type="cpu")
