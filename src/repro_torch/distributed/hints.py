"""Activation sharding hints — a mesh context for model-internal layout
(the torch port of :mod:`repro.distributed.hints`).

The models are mesh-agnostic; a sharded step activates a mesh context and
the layers call ``hint(x, DATA, None, MODEL, None)`` at the points where
the reference pins a layout (block boundaries, attention's q/k/v, the MoE
dispatch, the SSD heads).  Without an active context every hint is a
no-op, so tests and single-device runs never pay for it.

``DATA`` resolves to ("pod", "data") ∩ mesh axes; ``MODEL`` to "model".
Axis entries the mesh does not have are dropped.  With a mesh, a hint on a
DTensor redistributes it to the spec's placements
(:func:`repro_torch.distributed.sharding.placements`).  One departure: a
dim the named axes do not divide is replicated (the spec is fitted as
:func:`repro_torch.distributed.sharding._fit` fits parameters), where
GSPMD pads it; DTensor's view rules refuse an uneven shard (MoE's single
routing group at decode, 1 group over 16 data shards), and a shard of a
dim of extent 1, which is replicated too.  A plain
tensor is returned as it is: the tensors a model builds itself (masks,
positions, RoPE tables) are not sharded, and the step runs under
``implicit_replication``, which treats them as replicated.

The rest are the routes the models take where DTensor's own rules cannot
place an op, each a no-op without a mesh: :func:`split_ready` and
:func:`pin` around a reshape of heads, :func:`even` and
:func:`per_channel` after a matmul, :func:`local_offset` and
:func:`local_like` for a write into a sharded tensor, :func:`as_layout`
before an in-place copy, and :func:`remat_context` for a checkpointed
block's recompute.  A region
each rank computes on its own shards (attention's core, the SSD scan,
the MoE experts, the loss's rows) is PyTorch's
``torch.distributed.tensor.experimental.local_map`` at its call site.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["DATA", "MODEL", "sharding_hints", "hint", "active_mesh",
           "split_ready", "even", "per_channel", "pin", "is_dtensor",
           "local_offset", "local_like", "as_layout", "remat_context"]


class _Axis:
    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return f"<{self.name}>"


DATA = _Axis("DATA")
MODEL = _Axis("MODEL")

_state = threading.local()


def active_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def sharding_hints(mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def remat_context():
    """``context_fn`` for ``torch.utils.checkpoint``: the recompute of a
    checkpointed block runs in the backward, on autograd's device thread
    for a CUDA tensor, where this thread's mesh context is not set; it
    gets the mesh the forward had.  Without a mesh, checkpoint's own
    no-op."""
    mesh = active_mesh()
    if mesh is None:
        from torch.utils.checkpoint import noop_context_fn
        return noop_context_fn
    return lambda: (contextlib.nullcontext(), sharding_hints(mesh))


def _axis_names(mesh):
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _resolve(entry, names):
    if entry is DATA:
        axes = tuple(a for a in ("pod", "data") if a in names)
        return axes if axes else None
    if entry is MODEL:
        return "model" if "model" in names else None
    return entry


def hint(x: torch.Tensor, *spec) -> torch.Tensor:
    """Lay ``x`` out as ``spec`` under the active mesh: a DTensor is
    redistributed; without a mesh, when every entry resolves to None, or
    for a plain tensor, ``x`` itself is returned."""
    mesh = active_mesh()
    if mesh is None:
        return x
    names = _axis_names(mesh)
    resolved = tuple(_resolve(e, names) for e in spec)
    if all(e is None for e in resolved):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.distributed.sharding import _fit, placements
    fitted = tuple(None if n == 1 else e
                   for e, n in zip(_fit(resolved, x.shape, mesh), x.shape))
    return x.redistribute(x.device_mesh, placements(fitted, mesh))


def split_ready(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` laid out so that dim ``dim`` can be reshaped into ``(n,
    size // n)`` (heads, channels): DTensor's view rule keeps a shard of
    the split dim only over mesh dims whose sizes divide ``n``, and refuses
    the reshape otherwise, where GSPMD pads.  Such mesh dims are gathered
    (that dim replicated over them) first.  ``x`` itself without a mesh or
    for a plain tensor."""
    if active_mesh() is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    mesh, out, prod = x.device_mesh, list(x.placements), 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            if n % (prod * mesh.size(i)) == 0:
                prod *= mesh.size(i)
            else:
                out[i] = Replicate()
    return x if out == list(x.placements) else x.redistribute(mesh, out)


def even(x: torch.Tensor) -> torch.Tensor:
    """A matmul's output ``x`` with each ``Partial`` that DTensor would
    scatter unevenly reduced whole instead.  DTensor resolves a
    ``Partial`` for the next nonlinear op by scattering the first dim
    wherever that dim has at least as many rows as shards, even when
    they do not divide it (a batch of 5 on 2 data ranks, which the batch
    rules leave replicated), and its view rule then refuses to flatten the
    uneven shard, where GSPMD pads.  ``x`` itself without a mesh, for a
    plain tensor, or when every such split is even."""
    if active_mesh() is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    mesh, rows = x.device_mesh, 1          # shards of the first dim so far
    for i, p in enumerate(x.placements):
        if p.is_shard(0):
            rows *= mesh.size(i)
    out = [Replicate() if p.is_partial()
           and x.shape[0] >= rows * mesh.size(i)
           and x.shape[0] % (rows * mesh.size(i)) else p
           for i, p in enumerate(x.placements)]
    return x if out == list(x.placements) else x.redistribute(mesh, out)


def per_channel(v: torch.Tensor, y: torch.Tensor, dim: int = -1
                ) -> torch.Tensor:
    """A vector ``v`` over dim ``dim`` of ``y`` (a bias, a depthwise tap, a
    per-head scale) laid out to meet ``y`` elementwise: sharded where that
    dim of ``y`` is, whole elsewhere.  DTensor would otherwise move a
    sharded ``v`` to a ``Partial`` of ``y`` (a matmul's output), which
    torch 2.11 cannot.  ``v`` itself without a mesh or when ``y`` is a
    plain tensor."""
    if not is_dtensor(y):
        return v
    from torch.distributed.tensor import Replicate, Shard
    dim %= y.ndim
    return v.redistribute(y.device_mesh, [
        Shard(0) if q.is_shard(dim) else Replicate() for q in y.placements])


def pin(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its gradient laid out as ``x`` is: a DTensor is
    redistributed to its own placements, a no-op forward whose backward
    brings the incoming gradient to them.  Put after a merging reshape
    (heads into features), whose backward splits the gradient again and
    would meet a layout DTensor's view rule refuses (a feature dim sharded
    by the next matmul over more shards than there are heads).  ``x``
    itself without a mesh or for a plain tensor."""
    if active_mesh() is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, x.placements)


# ----------------------------------------------- local regions of a DTensor
def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (False, without importing DTensor,
    when no mesh is active)."""
    if active_mesh() is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_offset(x, dim: int) -> int:
    """Where this rank's block of dim ``dim`` of the DTensor ``x`` starts
    (an even shard, nested over its mesh dims in mesh order)."""
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    idx, n = 0, 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is not an even "
                         f"shard over {n}")
    return idx * (x.shape[dim] // n)


def local_like(x: torch.Tensor, ref, dims) -> torch.Tensor:
    """This rank's local tensor of ``x`` laid out to match the DTensor
    ``ref``: ``dims`` maps a dim of ``x`` to the dim of ``ref`` whose
    sharding it takes; every other dim of ``x`` is whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, ref.device_mesh,
                               [Replicate()] * ref.device_mesh.ndim,
                               run_check=False)
    back = {r: d for d, r in dims.items()}
    pl = [Shard(back[p.dim]) if p.is_shard() and p.dim in back
          else Replicate() for p in ref.placements]
    return x.redistribute(ref.device_mesh, pl).to_local()


def as_layout(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` redistributed to the DTensor ``ref``'s placements (for an
    in-place copy into ``ref``, which DTensor allows only between equal
    layouts); ``x`` itself when ``ref`` is a plain tensor."""
    if not is_dtensor(ref):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)

