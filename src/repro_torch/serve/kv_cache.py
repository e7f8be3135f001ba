"""KV-cache accounting and per-slot views — the port of
:mod:`repro.serve.kv_cache`.

The cache structures live with the models
(:class:`~repro_torch.models.attention.AttnCache`,
:func:`repro_torch.models.api.init_cache`): a dict of stacks whose every
leaf carries batch on axis 1, so one rule serves every stack.  This module
adds byte accounting per request slot and single-slot extract/insert, used
by the engine to prefill one request without touching live slots.
"""
from __future__ import annotations

from typing import Dict, Iterator

import torch

from repro_torch.models.api import init_cache
from repro_torch.models.attention import AttnCache
from repro_torch.models.config import ModelConfig

__all__ = ["cache_bytes", "bytes_per_slot", "slot_view", "slot_insert",
           "init_cache"]


def _leaves(cache: Dict[str, AttnCache]) -> Iterator[torch.Tensor]:
    for c in cache.values():
        yield c.k
        yield c.v


def cache_bytes(cache: Dict[str, AttnCache]) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(cache))


def bytes_per_slot(cfg: ModelConfig, max_len: int,
                   dtype=torch.bfloat16) -> int:
    """Cache bytes one request slot holds at context ``max_len`` (shapes
    only: the cache is laid out on the ``meta`` device, nothing is
    allocated)."""
    return cache_bytes(init_cache(cfg, 1, max_len, dtype, device="meta"))


def slot_view(cache: Dict[str, AttnCache], slot: int
              ) -> Dict[str, AttnCache]:
    """A batch=1 view of request ``slot`` (batch is axis 1).  It shares
    storage with ``cache``: a decode step on the view writes the slot in
    place, where the reference's ``dynamic_slice`` is a copy."""
    return {name: AttnCache(c.k.narrow(1, slot, 1), c.v.narrow(1, slot, 1),
                            c.ring)
            for name, c in cache.items()}


def slot_insert(cache: Dict[str, AttnCache],
                slot_cache: Dict[str, AttnCache], slot: int
                ) -> Dict[str, AttnCache]:
    """Write a batch=1 slot cache into the batched cache (in place) and
    return it.  A :func:`slot_view` of the same cache is already there."""
    for name, c in cache.items():
        u = slot_cache[name]
        for dst, src in ((c.k, u.k), (c.v, u.v)):
            view = dst.narrow(1, slot, 1)
            if view.data_ptr() != src.data_ptr():
                view.copy_(src)
    return cache
