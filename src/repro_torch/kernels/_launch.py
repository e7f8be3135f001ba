"""What every kernel wrapper of the port shares: the device rule, the
ctypes binding of a built library's C entry and its error check.

A wrapper takes its plain PyTorch version only for tensors on the CPU
(:func:`on_cpu` is true); for CUDA tensors it launches the kernel, and
for any other device it raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["P", "I", "LL", "on_cpu", "function", "raise_on_error",
           "check_cuda", "vectors"]

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong


def on_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (take the plain version), False for a CUDA
    tensor (launch the kernel); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return False


def function(lib: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``name`` of the library built from ``csrc/<lib>.cu``,
    typed on first use (a pointer passed untyped would be cut to 32 bits)."""
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = I
    return fn


def raise_on_error(lib: str, name: str, err: int) -> None:
    if err != 0:
        msg = _build.load(lib).repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def check_cuda(name: str, device: torch.device, **tensors) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def vectors(name: str, dtype: torch.dtype, *vs: torch.Tensor) -> tuple:
    """The 1-D inputs of an elementwise or reduction kernel at ``dtype``,
    checked for one length."""
    n = vs[0].shape
    for v in vs:
        if v.dim() != 1 or v.shape != n:
            raise ValueError(f"{name}: expected vectors of one length, got "
                             f"{[tuple(u.shape) for u in vs]}")
    return tuple(v.to(dtype) for v in vs)
