"""KV/state-cache accounting and per-slot views — the port of
:mod:`repro.serve.kv_cache`.

The cache structures live with the models
(:class:`~repro_torch.models.attention.AttnCache`,
:class:`~repro_torch.models.ssm.SSMCache`,
:func:`repro_torch.models.api.init_cache`): a dict whose entries are
stacks — a dataclass of tensors — or bare tensors (the encoder-decoder's
``cross_k``/``cross_v``), every tensor with batch on axis 1, so one rule
serves attention, SSM, hybrid and encoder-decoder caches, as the
reference's ``tree_map`` does.  This module adds byte accounting per
request slot and single-slot extract/insert, used by the engine to prefill
one request without touching live slots.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import torch

from repro_torch.models.api import init_cache
from repro_torch.models.config import ModelConfig

__all__ = ["cache_bytes", "bytes_per_slot", "slot_view", "slot_insert",
           "init_cache"]


def _tensors(c) -> Dict[str, torch.Tensor]:
    """A cache entry's tensors by name (``AttnCache``: k, v; ``SSMCache``:
    conv, ssm; a bare tensor: itself, under ``""``)."""
    if isinstance(c, torch.Tensor):
        return {"": c}
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
            if isinstance(getattr(c, f.name), torch.Tensor)}


def _rebuild(c, tensors: Dict[str, torch.Tensor]):
    """``c`` with its tensors replaced (:func:`_tensors`' names)."""
    if isinstance(c, torch.Tensor):
        return tensors[""]
    return dataclasses.replace(c, **tensors)


def _leaves(cache: Dict[str, object]) -> Iterator[torch.Tensor]:
    for c in cache.values():
        yield from _tensors(c).values()


def cache_bytes(cache: Dict[str, object]) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(cache))


def bytes_per_slot(cfg: ModelConfig, max_len: int,
                   dtype=torch.bfloat16) -> int:
    """Cache bytes one request slot holds at context ``max_len`` (shapes
    only: the cache is laid out on the ``meta`` device, nothing is
    allocated)."""
    return cache_bytes(init_cache(cfg, 1, max_len, dtype, device="meta"))


def slot_view(cache: Dict[str, object], slot: int) -> Dict[str, object]:
    """A batch=1 view of request ``slot`` (batch is axis 1).  It shares
    storage with ``cache``: a decode step on the view writes the slot in
    place, where the reference's ``dynamic_slice`` is a copy."""
    return {name: _rebuild(c, {f: t.narrow(1, slot, 1)
                               for f, t in _tensors(c).items()})
            for name, c in cache.items()}


def slot_insert(cache: Dict[str, object], slot_cache: Dict[str, object],
                slot: int) -> Dict[str, object]:
    """Write a batch=1 slot cache into the batched cache (in place) and
    return it.  A :func:`slot_view` of the same cache is already there."""
    for name, c in cache.items():
        src = _tensors(slot_cache[name])
        for f, dst in _tensors(c).items():
            view = dst.narrow(1, slot, 1)
            if view.data_ptr() != src[f].data_ptr():
                view.copy_(src[f])
    return cache
