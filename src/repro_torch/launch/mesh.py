"""Production mesh factory (the torch port of :mod:`repro.launch.mesh`).

Functions, not module-level constants: importing this module touches no
device and starts no process group.  Shapes: one pod of 256 devices as
(data=16, model=16); two pods, 512 devices, with a leading ``pod`` axis
that carries only data parallelism.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, which the caller starts first
(``torch.distributed.init_process_group``) at world size ``prod(shape)``:
one process a device, each holding its own shard of every DTensor.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_mesh"]


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with named ``axes`` (e.g. (2, 2) over
    4 gloo ranks on the CPU), on ``device_type`` (default ``"cuda"``).
    Raises ``RuntimeError`` unless a process group of world size
    ``prod(shape)`` is running."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise RuntimeError(
            f"a {shape} mesh needs a process group of world size {need}; "
            + ("none is running" if have is None else f"it has {have}")
            + " (start one with torch.distributed.init_process_group)")
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)
