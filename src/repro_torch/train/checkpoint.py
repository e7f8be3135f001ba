"""Atomic, versioned checkpoints (the torch port of
:mod:`repro.train.checkpoint`, with the same on-disk layout).

Layout (one directory per step)::

    <root>/step_000000123.tmp/   # staged write
        arrays.npz               # every leaf, host numpy, full
        manifest.json            # treedef, shapes/dtypes, sha256, metadata
    <root>/step_000000123/       # atomic os.replace on success

* **atomic** — a crash mid-write leaves only ``*.tmp``; ``latest_step``
  ignores them, ``restore`` never sees a torn checkpoint;
* **verified** — the manifest stores a sha256 over the ``arrays.npz``
  payload; a mismatch raises instead of resuming corrupt state;
* **complete** — parameters, optimizer state, data cursor and generator
  state live in one tree, so a resume is bit for bit.

A tree is nested dicts (and named tuples) of tensors or arrays; a leaf's
name is its path joined with ``/``, as the reference's are for dict trees,
so either package reads the other's checkpoints.  bf16 leaves are stored as
their ``uint16`` bits with dtype ``"bfloat16"`` (viewed through
``torch.int16``: the port does not import ``ml_dtypes``).

**Mesh-independent.**  A DTensor leaf is saved whole: :func:`save`
gathers it with ``full_tensor()`` on every rank (a collective, so every
rank calls ``save``), rank 0 writes, and every rank waits at a barrier;
the files are those of the unsharded tree, byte for byte.
``restore(..., shardings=)`` lays each loaded leaf out on a mesh that may
differ from the one that saved (elastic re-mesh,
:func:`repro_torch.train.fault.elastic_restore`).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "list_steps"]

_STEP_RE = re.compile(r"^step_(\d{9})$")
_CHUNK = 1 << 24


def _named_leaves(tree, prefix: str = ""):
    """``(name, leaf)`` pairs; dict keys sorted, as ``jax.tree_util``
    orders them."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    else:
        yield prefix, tree
        return
    for key, val in items:
        yield from _named_leaves(val, f"{prefix}/{key}" if prefix else key)


def _rebuild(template, leaves: Dict[str, Any], prefix: str = ""):
    """``template``'s structure with each leaf taken from ``leaves``."""
    def name(key):
        return f"{prefix}/{key}" if prefix else str(key)
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, name(k)) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(v, leaves, name(f))
                                for f, v in zip(template._fields, template)))
    return leaves[prefix]


def _to_host(leaf) -> tuple:
    """``(numpy array as stored, dtype name)``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def save(root: str, step: int, tree: Any,
         metadata: Optional[Dict] = None) -> str:
    """Stage and atomically publish one checkpoint.  Returns its path.
    A tree with DTensor leaves is saved by every rank together: each
    gathers the leaves, rank 0 writes, all meet at a barrier."""
    name = f"step_{step:09d}"
    final = os.path.join(root, name)
    leaves = list(_named_leaves(tree))
    sharded = any(_is_dtensor(v) for _, v in leaves)
    if sharded:
        import torch.distributed as dist
        writer = dist.get_rank() == 0
    arrays, dtypes = {}, {}
    for k, leaf in leaves:
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()           # a collective: every rank
        if not sharded or writer:
            arrays[k], dtypes[k] = _to_host(leaf)
    if sharded:
        if writer:
            _write(root, step, tree, arrays, dtypes, metadata)
        dist.barrier()
        return final
    return _write(root, step, tree, arrays, dtypes, metadata)


def _write(root: str, step: int, tree: Any, arrays: Dict, dtypes: Dict,
           metadata: Optional[Dict]) -> str:
    os.makedirs(root, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(root, name + ".tmp")
    final = os.path.join(root, name)
    os.makedirs(tmp, exist_ok=True)
    payload = os.path.join(tmp, "arrays.npz")
    with open(payload, "wb") as f:
        np.savez(f, **arrays)
    manifest = {
        "step": step,
        "sha256": _sha256(payload),
        "treedef": repr(_rebuild(tree, dict.fromkeys(arrays, "*"))),
        "leaves": {k: {"shape": list(a.shape), "dtype": dtypes[k]}
                   for k, a in arrays.items()},
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)

    if os.path.exists(final):                    # idempotent re-save
        shutil.rmtree(final)
    os.replace(tmp, final)                       # the atomic publish
    return final


def list_steps(root: str):
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        m = _STEP_RE.match(d)
        if m and os.path.isfile(os.path.join(root, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


def _from_host(a: np.ndarray, dtype: str, like) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def restore(root: str, template: Any, step: Optional[int] = None,
            shardings: Optional[Dict[str, Any]] = None):
    """Load a checkpoint into ``template``'s structure: each leaf a tensor
    at its saved dtype on the template leaf's device (the CPU for a
    non-tensor leaf).  A missing leaf raises ``KeyError``, a shape other
    than the template's ``ValueError``, a payload whose sha256 differs from
    the manifest's ``IOError``.  Returns ``(tree, metadata)``.

    ``shardings`` (``{leaf name: (mesh, placements)}``, e.g.
    :func:`repro_torch.distributed.sharding.named_shardings`; the mesh may
    differ from the one that saved) makes each named leaf a DTensor: every
    rank reads the whole leaf and keeps its own shard.  A template leaf
    that is a DTensor and has no entry keeps its own mesh and
    placements."""
    step = latest_step(root) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {root}")
    path = os.path.join(root, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    payload = os.path.join(path, "arrays.npz")
    digest = _sha256(payload)
    if digest != manifest["sha256"]:
        raise IOError(f"checkpoint {path} payload hash mismatch "
                      f"({digest[:12]} != {manifest['sha256'][:12]})")
    leaves = {}
    with np.load(payload) as arrays:
        for k, ref in _named_leaves(template):
            if k not in arrays.files:
                raise KeyError(f"checkpoint missing leaf {k!r}")
            a = arrays[k]
            want = tuple(ref.shape) if hasattr(ref, "shape") \
                else np.shape(ref)
            if tuple(a.shape) != tuple(want):
                raise ValueError(f"leaf {k!r} shape {a.shape} != template "
                                 f"{tuple(want)}")
            t = _from_host(a, manifest["leaves"][k]["dtype"], ref)
            sh = (shardings or {}).get(k)
            if sh is None and _is_dtensor(ref):
                sh = (ref.device_mesh, ref.placements)
            if sh is not None:
                from torch.distributed.tensor import distribute_tensor
                mesh, pl = sh
                t = distribute_tensor(t.to(mesh.device_type), mesh, pl,
                                      src_data_rank=None)
            leaves[k] = t
    return _rebuild(template, leaves), manifest["metadata"]
