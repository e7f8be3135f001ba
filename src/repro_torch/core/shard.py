"""Lane-axis sharding: G independent solves split over a list of devices
(the torch port of :mod:`repro.core.shard`).

The batched solver and the serving engine carry every per-system tensor
with a lane axis G.  Lanes are independent: every op of the tick is
lane-elementwise or a per-lane reduction, and the only cross-lane value
is the termination predicate ``any(active)``.  So the lane axis splits
over D devices with no collective inside a tick: lane shard d owns the
contiguous lanes ``d·G/D .. (d+1)·G/D`` and its operands and VM state live
on ``mesh[d]``.  One process drives every shard, as one controller drives
the reference's ``NamedSharding`` mesh.

A mesh is a tuple of :class:`torch.device`.  It may name one device more
than once (``("cpu",) * 4``, or ``(cuda:0, cuda:0)``): each shard is then
a separate set of tensors on that device.  A JAX ``Mesh`` cannot repeat a
device; the split of lanes is the same either way, and it is what lets
the CPU (one ``torch.device("cpu")``) and one card run D > 1.

A sharded solve is bit for bit the unsharded one, because:

* the bag is packed once and its stacked operands are cut along the lane
  axis (:func:`place_lanes`): no shard is stacked alone, so every lane
  keeps the whole bag's padded rows, widths and index dtype; a SELL
  operand's table is rebuilt per shard from its own lanes' widths
  (:meth:`repro_torch.kernels.spmv.SellTable.lanes`);
* a shard's per-lane reductions do not depend on how many lanes share the
  call (:func:`repro_torch.core.batch._row_dot`);
* the tick counter ``k`` is replicated: each shard's tick gates on its own
  lanes, and at every host sync ``k`` is set to the largest shard's
  (:func:`repro_torch.core.batch._run_chunked`), which is the count the
  unsharded loop reaches, since a lane that stopped never restarts within
  a call.  The predicate is read on the host once per sync chunk, as
  ``any`` over every shard.

Sharded runners and steppers take operands already laid out by
:func:`place_lanes` / :func:`place_vm_state` (a :class:`Shards`) and keep
no device of their own, so one cached runner serves every mesh of its
size.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["LANE_AXIS", "Shards", "lane_mesh", "mesh_shards",
           "mesh_signature", "pad_lanes", "place_lanes",
           "place_replicated", "place_vm_state", "shard_any",
           "LaneSharding", "lane_sharding"]

#: Name of the lane axis in a mesh signature.
LANE_AXIS = "lanes"

Mesh = Tuple[torch.device, ...]


class Shards(tuple):
    """One value per lane shard, shard d's on ``mesh[d]``: what
    :func:`place_lanes` returns and sharded runners and steppers take."""


def lane_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D lane mesh: ``devices`` as :class:`torch.device`, by default
    every visible CUDA device.  Without a card the default raises, as
    every entry point of the port does."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(resolve_device(d) for d in devices)
    if not mesh:
        raise ValueError("a lane mesh needs at least one device")
    return mesh


def mesh_shards(mesh) -> int:
    """Number of lane shards D: 1 for ``mesh=None`` (unsharded); a mesh
    or its :func:`mesh_signature` both read."""
    if mesh is None:
        return 1
    sig = mesh_signature(mesh)
    return int(sig[0][1])


def _is_signature(mesh) -> bool:
    return all(isinstance(a, tuple) and len(a) == 2 and isinstance(a[0], str)
               for a in mesh)


def mesh_signature(mesh) -> Optional[Tuple[Tuple[str, int], ...]]:
    """Hashable cache-key token of a mesh: ``(("lanes", D),)``.

    ``None`` stays ``None``, so a 1-shard mesh is distinct from no mesh
    (the sharded runner takes :class:`Shards`, the unsharded one
    tensors).  The devices do not enter it: runners keep none.  An
    already-folded signature passes through unchanged."""
    if mesh is None:
        return None
    mesh = tuple(mesh)
    if mesh and _is_signature(mesh):
        return mesh
    return ((LANE_AXIS, len(mesh)),)


def pad_lanes(g: int, mesh) -> int:
    """Smallest lane count ≥ ``g`` that the mesh's D divides: the batched
    front door pads a bag to it with inert identity lanes (converged at
    admission, dropped from the results)."""
    d = mesh_shards(mesh)
    return int(-(-max(int(g), 1) // d) * d)


def _lane_blocks(g: int, d: int):
    """``(start, stop)`` of each of ``d`` equal contiguous lane blocks of
    ``g`` lanes (``d`` divides ``g``)."""
    if g % d:
        raise ValueError(f"{g} lanes do not split into {d} equal shards")
    per = g // d
    return [(i * per, (i + 1) * per) for i in range(d)]


def _lane_piece(a, start: int, stop: int, device, lane_axis: int):
    from repro_torch.kernels.spmv import SellTable
    if isinstance(a, SellTable):
        return a.lanes(start, stop, device)
    piece = a.narrow(lane_axis, start, stop - start).to(device)
    return piece.contiguous()


class LaneSharding(NamedTuple):
    """The lane axis of an ``ndim``-d tensor split over a lane mesh, the
    other axes whole (the reference's ``NamedSharding`` of
    :func:`lane_sharding`)."""
    mesh: Mesh
    ndim: int
    lane_axis: int

    def shard_indices(self, shape) -> Tuple[tuple, ...]:
        """Each shard's index into a tensor of ``shape``: the slices
        :func:`place_lanes` cuts, shard d's block on ``mesh[d]``."""
        if len(shape) != self.ndim:
            raise ValueError(f"a {self.ndim}-d sharding, a shape {shape}")
        out = []
        for start, stop in _lane_blocks(shape[self.lane_axis],
                                        len(self.mesh)):
            idx = [slice(None)] * self.ndim
            idx[self.lane_axis] = slice(start, stop)
            out.append(tuple(idx))
        return tuple(out)


def lane_sharding(mesh, ndim: int, lane_axis: int = 0) -> LaneSharding:
    """``lane_axis`` of an ``ndim``-d tensor split over ``mesh`` (a tuple
    of devices), the rest whole."""
    return LaneSharding(tuple(mesh), int(ndim), int(lane_axis))


def place_lanes(mesh, arrays, lane_axis: int = 0):
    """Cut a tensor, or a tuple/list of tensors (an operand; a SELL table
    in it is rebuilt per shard), along ``lane_axis`` into the mesh's D
    contiguous lane blocks, block d on ``mesh[d]``.  Returns a
    :class:`Shards` of pieces (of tuples for a tuple).  No-op for
    ``mesh=None`` and for what is already a :class:`Shards`.  A piece on
    the device it came from is a view of the whole: operands are read,
    never written, by the tick."""
    if mesh is None or isinstance(arrays, Shards):
        return arrays
    mesh = tuple(mesh)
    seq = isinstance(arrays, (tuple, list))
    first = next(a for a in (arrays if seq else (arrays,))
                 if isinstance(a, torch.Tensor))
    blocks = _lane_blocks(first.shape[lane_axis], len(mesh))
    out = []
    for dev, (start, stop) in zip(mesh, blocks):
        if seq:
            out.append(type(arrays)(_lane_piece(a, start, stop, dev,
                                                lane_axis) for a in arrays))
        else:
            out.append(_lane_piece(arrays, start, stop, dev, lane_axis))
    return Shards(out)


def place_replicated(mesh, x):
    """One copy of ``x`` on each mesh device (no-op for ``mesh=None``)."""
    if mesh is None or isinstance(x, Shards):
        return x
    return Shards(x.to(dev, copy=True) for dev in mesh)


def place_vm_state(mesh, state):
    """Lay a :class:`repro_torch.core.vm.BatchedVMState` out over the mesh:
    ``mem``/``queues``/``sregs`` carry the lane axis at position 1, the
    rest at 0, and the tick ``k`` is replicated.  Every piece is a copy
    (the tick writes state in place)."""
    if mesh is None or isinstance(state, Shards):
        return state

    def split(t, axis=0):
        return [p.clone() for p in place_lanes(mesh, t, lane_axis=axis)]

    fields = dict(it=split(state.it), status=split(state.status),
                  mem=split(state.mem, 1), queues=split(state.queues, 1),
                  sregs=split(state.sregs, 1), active=split(state.active),
                  trace=split(state.trace), k=place_replicated(mesh, state.k))
    return Shards(state._replace(**{f: v[d] for f, v in fields.items()})
                  for d in range(len(tuple(mesh))))


def shard_any(flags) -> bool:
    """``any`` over every shard's flags (a 0-d flag is its own ``any``),
    read on the host once: each shard's is gathered on the first shard's
    device."""
    flags = [f if f.dim() == 0 else f.any() for f in flags]
    if len(flags) == 1:
        return bool(flags[0])
    home = flags[0].device
    return bool(torch.stack([f.to(home) for f in flags]).any())
