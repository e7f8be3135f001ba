"""Sharding rules — FSDP(data) × TP(model) × EP(experts→model) × DP(pod)
(the torch port of :mod:`repro.distributed.sharding`, on DTensor).

One rule engine covers every assigned architecture.  Conventions:

* **TP (model axis)**: attention/ssm projection *output* features, MLP
  hidden ``d_ff``, MoE expert axis, vocab dim of the embedding.
* **FSDP (data axis)**: the projection *input* dim.
* **DP (pod axis)**: batch only.
* A dim the mesh does not divide is replicated (:func:`_fit`), e.g.
  whisper's 51,865-token vocab.

A **spec** is the reference's ``PartitionSpec`` as a plain tuple, one
entry a tensor dim: ``None`` (replicated), an axis name, or a tuple of
axis names (the dim split over several mesh axes, the first the major
one).  :func:`named_shardings` turns specs into DTensor placements, one
per mesh dim: ``Shard(d)`` where the mesh dim's name appears in entry
``d``, else ``Replicate()``.  DTensor nests the mesh dims that shard one
tensor dim in mesh order, left to right, which is JAX's major-to-minor
order for an entry that names them in mesh order (the only order these
rules produce; another raises).

The rules read parameter *names and ranks*.  The reference stacks an
LM's layers on a leading axis and its rules branch on the stacked rank;
the port keeps one tensor a layer (``layers.<l>.…``, and whisper's
``enc_layers.<l>.…`` / ``dec_layers.<l>.…``), so :func:`param_specs`
applies the rule at the stacked rank and drops its leading ``None``.

A mesh is a ``DeviceMesh`` (:mod:`repro_torch.launch.mesh`); the spec
functions read only its axis names and sizes, so anything with
``axis_names`` and a ``shape`` mapping of them (the reference's
``Mesh``) serves too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch import nn

__all__ = ["param_specs", "batch_specs", "cache_specs", "data_axes",
           "named_shardings", "activation_spec", "placements",
           "NamedSharding", "distribute", "distribute_tree", "is_spec"]

#: the LM stacks the reference stacks on a leading layer axis
_STACKED = ("layers", "enc_layers", "dec_layers")


class NamedSharding(NamedTuple):
    """A mesh and the DTensor placements of one tensor on it."""
    mesh: Any
    placements: Tuple


def _axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` or of a
    mesh with ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def data_axes(mesh) -> Tuple[str, ...]:
    """Batch-parallel axes: ('pod', 'data') on multi-pod, ('data',) else."""
    sizes = _axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _rule(names: Tuple[str, ...], ndim: int) -> tuple:
    """The reference's rule for a leaf at path ``names`` of rank ``ndim``
    (stacked rank for a stacked leaf)."""
    js = "/".join(names)
    leaf = names[-1] if names else ""

    # ---- embeddings: vocab on model (biggest single tensor) ----
    if "embed" in js:
        return ("model", None)

    # ---- MoE expert-stacked weights [L, E, D, F] / [L, E, F, D] ----
    if ndim == 4:
        if leaf == "wo":
            return (None, "model", None, "data")
        return (None, "model", "data", None)    # wi / wg
    if "router" in js:
        return (None, None, None) if ndim == 3 else (None, None)

    # ---- projection kernels ----
    in_proj = ("wq", "wk", "wv", "wi", "wg", "in_proj")
    out_proj = ("wo", "out_proj")
    parent = names[-2] if len(names) >= 2 else ""
    if leaf == "w" and parent in in_proj:
        return (None, "data", "model") if ndim == 3 else ("data", "model")
    if leaf == "w" and parent in out_proj:
        return (None, "model", "data") if ndim == 3 else ("model", "data")
    if leaf == "b" and parent in in_proj + out_proj:
        return (None, "model") if ndim == 2 else ("model",)

    # ---- SSM extras ----
    if leaf == "conv_w":
        return (None, None, "model") if ndim == 3 else (None, "model")
    if leaf == "conv_b":
        return (None, "model") if ndim == 2 else ("model",)
    if leaf in ("A_log", "D", "dt_bias"):
        return (None, "model") if ndim == 2 else ("model",)

    # ---- norms / everything else: replicated ----
    return (None,) * ndim


def _norm(spec: tuple) -> tuple:
    """A one-axis tuple entry as the axis name (``PartitionSpec``'s own
    normal form: ``P(("data",))`` is ``P("data")``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _fit(spec: tuple, shape, mesh) -> tuple:
    """Drop spec axes whose mesh-axis product does not divide the dim, so
    e.g. whisper's 51 865 vocab replicates."""
    if mesh is None:
        return _norm(spec)
    sizes = _axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= sizes[a]
        out.append(entry if dim % size == 0 else None)
    return _norm(tuple(out))


def _port_rule(name: str, ndim: int) -> tuple:
    """The rule for port parameter ``name``: a stacked layer's tensor
    (``layers.<l>.<path>``) takes the reference's rule at rank + 1 without
    its leading (layer) entry."""
    parts = tuple(name.split("."))
    if len(parts) > 2 and parts[0] in _STACKED and parts[1].isdigit():
        spec = _rule((parts[0],) + parts[2:], ndim + 1)
        assert spec[0] is None, (name, spec)
        return spec[1:]
    return _rule(parts, ndim)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_specs(params_or_shapes, mesh=None) -> Dict[str, tuple]:
    """``{port name: spec}`` for a module (its ``named_parameters``) or a
    ``{name: tensor or shape}`` mapping.  With ``mesh``, specs are
    divisibility-fitted."""
    if isinstance(params_or_shapes, nn.Module):
        params_or_shapes = dict(params_or_shapes.named_parameters())
    return {n: _fit(_port_rule(n, len(_shape(v))), _shape(v), mesh)
            for n, v in params_or_shapes.items()}


def batch_specs(batch: Dict[str, Any], mesh) -> Dict[str, tuple]:
    """Specs for a train/prefill batch dict: batch dim over (pod, data)."""
    dp = data_axes(mesh)
    out = {}
    for k, leaf in batch.items():
        shape = _shape(leaf)
        out[k] = () if not shape else _fit(
            (dp,) + (None,) * (len(shape) - 1), shape, mesh)
    return out


def _map_named(tree, fn, names: Tuple[str, ...] = ()):
    """``tree`` with each tensor leaf ``t`` replaced by ``fn(names, t)``;
    dicts, dataclasses and named tuples are walked by key / field name,
    other leaves (a cache's ``ring`` flag) kept."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, names + (str(k),))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_named(getattr(tree, f.name), fn, names + (f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(v, fn, names + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, torch.Tensor):
        return fn(names, tree)
    return tree


def cache_specs(cache, mesh, *, batch: int):
    """Decode-cache specs, in the cache's own structure (a spec in place
    of each tensor).

    batch ≥ |data|  → batch on data, cache length on model;
    batch 1 (long_500k) → cache length over (data × model), heads/channels
    on model where present.
    """
    dp = data_axes(mesh)
    sizes = _axis_sizes(mesh)
    dsize = 1
    for a in dp:
        dsize *= sizes[a]
    msize = sizes.get("model", 1)
    big_batch = batch % dsize == 0 and batch >= dsize

    def spec(names, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 5 and "ssm" in names:   # SSD state [L, B, H, P, N]
            h_ok = shape[2] % msize == 0
            s = (None, dp if big_batch else None,
                 "model" if h_ok else None, None, None)
        elif nd == 5 and "cross" in names:  # enc-dec cross KV
            s = (None, dp if big_batch else None, None, None, None)
        elif nd == 5:                    # stacked KV, head-major:
            if big_batch:                # [L, B, H, S, D]
                seq_ok = shape[3] % msize == 0
                s = (None, dp, None, "model" if seq_ok else None, None)
            else:
                seq_ok = shape[3] % (dsize * msize) == 0
                s = (None, None, None,
                     ("data", "model") if seq_ok else None, None)
        elif nd == 4:                    # conv taps [L, B, K-1, C]
            c_ok = shape[3] % msize == 0
            s = (None, dp if big_batch else None, None,
                 "model" if c_ok else None)
        else:
            s = (None,) * nd
        return _fit(s, shape, mesh)

    return _map_named(cache, spec)


def activation_spec(mesh, seq_len: int, *,
                    seq_parallel_above: int = 8192) -> tuple:
    """Block-boundary activation spec [B, S, D].

    Long sequences shard S on the model axis between blocks (sequence
    parallelism); short sequences keep S replicated (pure TP inside).
    """
    dp = data_axes(mesh)
    msize = _axis_sizes(mesh).get("model", 1)
    if seq_len >= seq_parallel_above and seq_len % msize == 0:
        return _norm((dp, "model", None))
    return _norm((dp, None, None))


def is_spec(x) -> bool:
    """A spec: a plain tuple of ``None``, axis names and tuples of them."""
    return type(x) is tuple and all(
        e is None or isinstance(e, str)
        or (type(e) is tuple and all(isinstance(a, str) for a in e))
        for e in x)


def placements(spec: tuple, mesh) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where that dim's name is in entry ``d``, else
    ``Replicate()``.  An axis named twice, or an entry whose axes are not
    in mesh order (DTensor nests them in mesh order), raises
    ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(_axis_sizes(mesh))
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        if [order.index(a) for a in axes] != sorted(
                order.index(a) for a in axes):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of "
                             f"the mesh's order {tuple(order)}")
        for a in axes:
            if a in where:
                raise ValueError(f"spec {spec!r} names axis {a!r} twice")
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in order)


def named_shardings(specs, mesh):
    """``specs`` (a dict, a dataclass tree of specs, or one spec) with
    each spec replaced by its :class:`NamedSharding` on ``mesh``."""
    if is_spec(specs):
        return NamedSharding(mesh, placements(specs, mesh))
    if isinstance(specs, dict):
        return {k: named_shardings(v, mesh) for k, v in specs.items()}
    if dataclasses.is_dataclass(specs) and not isinstance(specs, type):
        return dataclasses.replace(specs, **{
            f.name: named_shardings(getattr(specs, f.name), mesh)
            for f in dataclasses.fields(specs)})
    return specs


def _to_dtensor(t: torch.Tensor, sharding: NamedSharding):
    """``t`` (the whole tensor, the same on every rank) as a DTensor:
    each rank keeps its own shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def distribute_tree(tree, shardings):
    """``tree`` (a dict / dataclass tree of whole tensors, the same on
    every rank) with each tensor made a DTensor by the
    :class:`NamedSharding` at its place in ``shardings`` (the same
    structure, e.g. :func:`named_shardings` of :func:`cache_specs`)."""
    flat = {}
    _collect(shardings, flat)
    return _map_named(tree, lambda names, t: _to_dtensor(t, flat[names]))


def _collect(tree, out: dict, names: Tuple[str, ...] = ()) -> None:
    if isinstance(tree, NamedSharding):
        out[names] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _collect(v, out, names + (str(k),))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _collect(getattr(tree, f.name), out, names + (f.name,))


@torch.no_grad()
def distribute(module: nn.Module, mesh) -> nn.Module:
    """Swap each parameter of ``module`` (whole, the same on every rank)
    for its DTensor by :func:`param_specs` on ``mesh``, in place; each
    rank keeps only its shard.  Returns the module."""
    shardings = named_shardings(param_specs(module, mesh), mesh)
    for name, p in list(module.named_parameters()):
        owner, _, attr = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        setattr(sub, attr, nn.Parameter(_to_dtensor(p.data, shardings[name]),
                                        requires_grad=p.requires_grad))
    return module
