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
``tree_sum`` of :mod:`repro_torch.core.batch` (one CUDA block each), and
the chunk sums by the same tree (a second launch).  No floating-point
atomics, so a kernel's result is the same on every run and equal bit for
bit to its plain version.  Bound by bytes: each input is read once.

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


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def n_chunks(n: int) -> int:
    return max(1, -(-n // CHUNK))


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
    fn = function("dot", "repro_dot", [I, P, P, LL, P, P, P])
    with torch.cuda.device(a.device):
        err = fn(code, a.data_ptr(), b.data_ptr(), n, part.data_ptr(),
                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
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
    if on_cpu("dot3", r):
        return dot3_plain(r, u, w, acc_dtype=acc_dtype)
    acc = r.dtype if acc_dtype is None else acc_dtype
    r, u, w = vectors("dot3", acc, r, u, w)
    code = dtype_code("dot3", r)
    check_cuda("dot3", r.device, r=r, u=u, w=w)
    n = r.shape[0]
    part = torch.empty(3 * n_chunks(n), dtype=acc, device=r.device)
    out = torch.empty(3, dtype=acc, device=r.device)
    fn = function("dot", "repro_dot3", [I, P, P, P, LL, P, P, P])
    with torch.cuda.device(r.device):
        err = fn(code, r.data_ptr(), u.data_ptr(), w.data_ptr(), n,
                 part.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    raise_on_error("dot", "dot3", err)
    LAUNCHES["dot3"] += 1
    return out
