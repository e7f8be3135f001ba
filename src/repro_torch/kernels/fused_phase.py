"""Fused JPCG phase kernels for Hopper, each beside its plain PyTorch
version (the paper's §5 streaming reuse, one kernel per phase).

* :func:`phase2` replaces ``repro/kernels/fused_phase.py::phase2_pallas``:
  M4 ``r' = r − α·ap``, M8 ``rr = r'·r'``, M5 ``z = r'/M`` and M6
  ``rz = r'·z``.  It reads r, ap and M once, writes r' once, and keeps z
  in a register; the two scalars come from the same two-level
  :func:`~repro_torch.kernels.dot.chunk_tree` as :func:`~repro_torch.
  kernels.dot.dot`.
* :func:`phase3` replaces ``::phase3_pallas``: z recomputed from r' and M
  (§5.3), M7 ``p' = z + β·p`` and M3 ``x' = x + α·p`` — p read once for
  both outputs.

Both are ``csrc/fused_phase.cu``.  ``alpha`` and ``beta`` are 0-d device
tensors the kernels read through a pointer, so the solve loop never
copies them to the host.  The ragged tail is handled by bounds checks,
not by the TPU side's tile padding and ones-padded M.  Every operation is
correctly rounded and nothing is contracted (``--fmad=false``), so each
kernel is bitwise equal to its plain version.  Bound by bytes: phase 2
moves 3R + 1W vectors, phase 3 4R + 2W.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  :data:`LAUNCHES` counts the
launches of each kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels._launch import (I, LL, P, check_cuda, function,
                                         on_cpu, raise_on_error, vectors)
from repro_torch.kernels.dot import chunk_tree, dtype_code, n_chunks

__all__ = ["phase2", "phase2_plain", "phase3", "phase3_plain", "LAUNCHES",
           "reset_launches"]

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"phase2": 0, "phase3": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _scalar(name: str, s, like: torch.Tensor) -> torch.Tensor:
    s = torch.as_tensor(s, dtype=like.dtype, device=like.device)
    if s.numel() != 1:
        raise ValueError(f"{name}: expected one scalar, got shape "
                         f"{tuple(s.shape)}")
    return s.reshape(())


def phase2_plain(alpha, r: torch.Tensor, ap: torch.Tensor,
                 diag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(r', [r'·r', r'·z])`` with ``r' = r − α·ap``, ``z = r'/M``."""
    r, ap, diag = vectors("phase2", r.dtype, r, ap, diag)
    alpha = _scalar("phase2", alpha, r)
    r_new = r - alpha * ap
    z = r_new / diag
    return r_new, chunk_tree(torch.stack([r_new * r_new, r_new * z]))


def phase2(alpha, r: torch.Tensor, ap: torch.Tensor,
           diag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused phase 2 (the port of ``phase2_pallas``).  Returns
    ``(r_new [n], scalars [rr, rz])`` at ``r.dtype``."""
    if on_cpu("phase2", r):
        return phase2_plain(alpha, r, ap, diag)
    r, ap, diag = vectors("phase2", r.dtype, r, ap, diag)
    alpha = _scalar("phase2", alpha, r)
    code = dtype_code("phase2", r)
    check_cuda("phase2", r.device, r=r, ap=ap, diag=diag)
    n = r.shape[0]
    r_new = torch.empty_like(r)
    part = torch.empty(2 * n_chunks(n), dtype=r.dtype, device=r.device)
    out = torch.empty(2, dtype=r.dtype, device=r.device)
    fn = function("fused_phase", "repro_phase2",
                  [I, P, P, P, P, P, LL, P, P, P])
    with torch.cuda.device(r.device):
        err = fn(code, alpha.data_ptr(), r.data_ptr(), ap.data_ptr(),
                 diag.data_ptr(), r_new.data_ptr(), n, part.data_ptr(),
                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    raise_on_error("fused_phase", "phase2", err)
    LAUNCHES["phase2"] += 1
    return r_new, out


def phase3_plain(alpha, beta, r_new: torch.Tensor, diag: torch.Tensor,
                 p: torch.Tensor, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(p', x')`` with ``p' = r'/M + β·p``, ``x' = x + α·p``."""
    r_new, diag, p, x = vectors("phase3", r_new.dtype, r_new, diag, p, x)
    alpha = _scalar("phase3", alpha, r_new)
    beta = _scalar("phase3", beta, r_new)
    z = r_new / diag
    return z + beta * p, x + alpha * p


def phase3(alpha, beta, r_new: torch.Tensor, diag: torch.Tensor,
           p: torch.Tensor, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused phase 3 (the port of ``phase3_pallas``).  Returns
    ``(p_new [n], x_new [n])`` at ``r_new.dtype``."""
    if on_cpu("phase3", r_new):
        return phase3_plain(alpha, beta, r_new, diag, p, x)
    r_new, diag, p, x = vectors("phase3", r_new.dtype, r_new, diag, p, x)
    alpha = _scalar("phase3", alpha, r_new)
    beta = _scalar("phase3", beta, r_new)
    code = dtype_code("phase3", r_new)
    check_cuda("phase3", r_new.device, r_new=r_new, diag=diag, p=p, x=x)
    p_new = torch.empty_like(p)
    x_new = torch.empty_like(x)
    fn = function("fused_phase", "repro_phase3",
                  [I, P, P, P, P, P, P, P, P, LL, P])
    with torch.cuda.device(r_new.device):
        err = fn(code, alpha.data_ptr(), beta.data_ptr(), r_new.data_ptr(),
                 diag.data_ptr(), p.data_ptr(), x.data_ptr(),
                 p_new.data_ptr(), x_new.data_ptr(), r_new.shape[0],
                 torch.cuda.current_stream().cuda_stream)
    raise_on_error("fused_phase", "phase3", err)
    LAUNCHES["phase3"] += 1
    return p_new, x_new
