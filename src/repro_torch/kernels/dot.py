"""Dot-product kernels for Hopper — the M2 dot and the pipelined-CG dot3 —
each beside its plain PyTorch version.

* :func:`dot` replaces ``repro/kernels/dot.py::dot_pallas`` (⟨a, b⟩ at
  ``acc_dtype``): the single-system loop's ``p·ap``.
* :func:`dot3` replaces ``repro/kernels/dot.py::dot3_pallas`` (the fused
  ``[r·u, w·u, r·r]`` of pipelined CG, one sweep over r, u, w), reached
  through :func:`repro_torch.kernels.ops.make_dot3`.

Both are ``csrc/dot.cu``.  The TPU kernels accumulate an ``[8, 512]``
tile of lane partials across a sequential grid; Hopper has no such grid,
so the sum is :func:`chunk_tree`: the products, padded with +0, are cut
into chunks of :data:`CHUNK`, each chunk is reduced by the halving
``tree_sum`` of :mod:`repro_torch.core.batch` (by one CUDA block), and
the chunk sums by the same tree.  Both kernels are one launch: the block
that finishes last (an integer ticket on a counter the wrapper keeps per
device and stream) reduces the chunk sums.  Both run a block per chunk;
:func:`dot3`'s block reads its chunk of r, u and w into shared memory
with bulk asynchronous copies (TMA) that complete on an mbarrier, and a
slice a bulk copy cannot take (an address not 16-byte aligned, a ragged
last chunk whose bytes are not a multiple of 16) with plain loads, on the
card.  No floating-point atomics, so a kernel's result is the same on
every run and equal bit for bit to its plain version.  Bound by bytes:
each input is read once.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  :data:`LAUNCHES` counts the
launches of each kernel.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels._launch import (I, LL, P, check_cuda, function,
                                         on_cpu, raise_on_error, vectors)

__all__ = ["CHUNK", "chunk_tree", "n_chunks", "dot", "dot_plain", "dot3",
           "dot3_plain", "LAUNCHES", "reset_launches", "dtype_code"]

#: Leaves per CUDA block of the first level (``kChunk`` in
#: ``csrc/reduce.cuh``: 256 threads × 8 leaves).
CHUNK = 2048

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"dot": 0, "dot3": 0}

_DTYPE_CODE = {torch.float64: 0, torch.float32: 1}

#: (device index, stream) -> the ticket counter of dot and dot3, 0 between
#: calls (calls on one stream run one after the other).
_TICKETS: Dict[tuple, torch.Tensor] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def n_chunks(n: int) -> int:
    return max(1, -(-n // CHUNK))


def _ticket(device: torch.device) -> tuple:
    """``(stream, ticket)``: the current stream of ``device`` and its ticket
    counter."""
    stream = torch.cuda.current_stream().cuda_stream
    key = (device.index, stream)
    ticket = _TICKETS.get(key)
    if ticket is None:
        ticket = _TICKETS[key] = torch.zeros(1, dtype=torch.int32,
                                             device=device)
    return stream, ticket


def chunk_tree(p: torch.Tensor) -> torch.Tensor:
    """The kernels' two-level sum over the last axis of ``p``: pad with +0
    to whole chunks of :data:`CHUNK`, ``tree_sum`` each chunk, then
    ``tree_sum`` the chunk sums."""
    from repro_torch.core.batch import tree_sum
    n = p.shape[-1]
    nb = n_chunks(n)
    if nb * CHUNK != n:
        p = torch.cat([p, p.new_zeros(*p.shape[:-1], nb * CHUNK - n)], dim=-1)
    part = tree_sum(p.reshape(*p.shape[:-1], nb, CHUNK), dim=-1)
    return tree_sum(part, dim=-1)


def dtype_code(name: str, t: torch.Tensor) -> int:
    try:
        return _DTYPE_CODE[t.dtype]
    except KeyError:
        raise ValueError(f"{name}: dtype {t.dtype} is not float32/float64"
                         ) from None


def dot_plain(a: torch.Tensor, b: torch.Tensor, *,
              acc_dtype=None) -> torch.Tensor:
    """⟨a, b⟩ as the kernel sums it: ``chunk_tree(a·b)``, 0-d."""
    acc = a.dtype if acc_dtype is None else acc_dtype
    a, b = vectors("dot", acc, a, b)
    return chunk_tree(a * b)


def dot(a: torch.Tensor, b: torch.Tensor, *, acc_dtype=None) -> torch.Tensor:
    """⟨a, b⟩ at ``acc_dtype`` (default ``a.dtype``), a 0-d tensor (the
    port of ``dot_pallas``)."""
    if on_cpu("dot", a):
        return dot_plain(a, b, acc_dtype=acc_dtype)
    acc = a.dtype if acc_dtype is None else acc_dtype
    a, b = vectors("dot", acc, a, b)
    code = dtype_code("dot", a)
    check_cuda("dot", a.device, a=a, b=b)
    n = a.shape[0]
    part = torch.empty(n_chunks(n), dtype=acc, device=a.device)
    out = torch.empty((), dtype=acc, device=a.device)
    fn = function("dot", "repro_dot", [I, P, P, LL, P, P, P, P])
    with torch.cuda.device(a.device):
        stream, ticket = _ticket(a.device)
        err = fn(code, a.data_ptr(), b.data_ptr(), n, part.data_ptr(),
                 out.data_ptr(), ticket.data_ptr(), stream)
    raise_on_error("dot", "dot", err)
    LAUNCHES["dot"] += 1
    return out


def dot3_plain(r: torch.Tensor, u: torch.Tensor, w: torch.Tensor, *,
               acc_dtype=None) -> torch.Tensor:
    """``[r·u, w·u, r·r]`` as the kernel sums them, shape (3,)."""
    acc = r.dtype if acc_dtype is None else acc_dtype
    r, u, w = vectors("dot3", acc, r, u, w)
    return chunk_tree(torch.stack([r * u, w * u, r * r]))


def dot3(r: torch.Tensor, u: torch.Tensor, w: torch.Tensor, *,
         acc_dtype=None) -> torch.Tensor:
    """Fused ``[r·u, w·u, r·r]`` in one sweep over r, u, w, shape (3,)
    (the port of ``dot3_pallas``)."""
    acc = r.dtype if acc_dtype is None else acc_dtype
    if acc not in _DTYPE_CODE:
        raise ValueError(f"dot3: dtype {acc} is not float32/float64")
    if on_cpu("dot3", r):
        return dot3_plain(r, u, w, acc_dtype=acc)
    r, u, w = vectors("dot3", acc, r, u, w)
    check_cuda("dot3", r.device, r=r, u=u, w=w)
    n = r.shape[0]
    part = torch.empty(3 * n_chunks(n), dtype=acc, device=r.device)
    out = torch.empty(3, dtype=acc, device=r.device)
    fn = function("dot", "repro_dot3", [I, P, P, P, LL, P, P, P, P])
    with torch.cuda.device(r.device):
        stream, ticket = _ticket(r.device)
        err = fn(_DTYPE_CODE[acc], r.data_ptr(), u.data_ptr(), w.data_ptr(),
                 n, part.data_ptr(), out.data_ptr(), ticket.data_ptr(),
                 stream)
    raise_on_error("dot", "dot3", err)
    LAUNCHES["dot3"] += 1
    return out
