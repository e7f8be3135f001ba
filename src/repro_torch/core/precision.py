"""Mixed-precision schemes for the JPCG SpMV (paper §6, Table 1).

Same table as :mod:`repro.core.precision`, with torch dtypes:

  ============  ======  ======  ======
  scheme        A       x_in    y_out     (vector_dtype = FP64)
  ============  ======  ======  ======
  fp64          FP64    FP64    FP64
  mixed_v1      FP32    FP32    FP32
  mixed_v2      FP32    FP32    FP64
  mixed_v3      FP32    FP64    FP64   <- Callipepla's choice
  ============  ======  ======  ======

and the TPU tier one level down (``vector_dtype`` = FP32):

  ============  ======  ======  ======
  tpu_fp32      FP32    FP32    FP32
  tpu_v1        BF16    BF16    BF16
  tpu_v2        BF16    BF16    FP32
  tpu_v3        BF16    FP32    FP32
  ============  ======  ======  ======

numpy has no bf16 type, and the port does not count on ``ml_dtypes``
(the card's machine has none).  So the host stackers carry bf16 values
as their bit patterns, ``uint16`` (:data:`BF16_CARRIER`, what
:attr:`PrecisionScheme.host_matrix_dtype` returns for the ``tpu_v*``
schemes): :func:`bf16_bits` rounds to them and :func:`values_tensor`
puts host values on a device at a scheme's dtype, bits included.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["PrecisionScheme", "get_scheme", "SCHEMES", "BF16_CARRIER",
           "bf16_bits", "host_values", "values_tensor"]

#: How the host holds bf16 values: their bit patterns.
BF16_CARRIER = np.dtype(np.uint16)

_HOST = {torch.float64: np.dtype(np.float64),
         torch.float32: np.dtype(np.float32),
         torch.bfloat16: BF16_CARRIER}


def bf16_bits(a) -> np.ndarray:
    """``a`` rounded to bf16, as ``uint16`` bit patterns.

    The rounding is the reference's ``astype(jnp.bfloat16)``: to fp32
    first, then round-to-nearest-even on the 16 bits dropped; a NaN stays
    a (quiet) NaN of its sign."""
    a = np.asarray(a)
    if a.dtype == BF16_CARRIER:
        return a
    if a.dtype.name == "bfloat16":         # ml_dtypes' type, read as bits
        return a.view(BF16_CARRIER)
    with np.errstate(over="ignore"):       # beyond fp32's range: ±inf
        u = np.asarray(a, np.float32, order="C").view(np.uint32)
    odd = (u >> np.uint32(16)) & np.uint32(1)
    out = ((u + np.uint32(0x7FFF) + odd) >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(a)
    if nan.any():
        out[nan] = ((u[nan] >> np.uint32(16)) | np.uint32(0x40)).astype(
            np.uint16)
    return out


def host_values(a, dtype: np.dtype) -> np.ndarray:
    """Matrix values at a host stacking dtype (bf16: their bits)."""
    if np.dtype(dtype) == BF16_CARRIER:
        return bf16_bits(a)
    return np.asarray(a).astype(dtype, copy=False)


def values_tensor(a, device, dtype=None) -> torch.Tensor:
    """A host array as a ``dtype`` tensor on ``device``, without a host
    copy where it is contiguous.  bf16 goes through its bits: ``uint16``
    (or ``ml_dtypes`` bf16; floats are rounded first) viewed as
    ``int16``, moved, viewed as ``torch.bfloat16``; anything else numpy
    reads is converted by torch."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    a = np.asarray(a)
    if dtype == torch.bfloat16:
        bits = bf16_bits(a)
        if not (bits.flags.c_contiguous and bits.flags.writeable):
            bits = np.array(bits, order="C")
        bits = bits.view(np.int16)
        return torch.from_numpy(bits).to(device).view(torch.bfloat16)
    if a.dtype == BF16_CARRIER:
        raise ValueError(f"uint16 values are bf16 bits; asked for {dtype}")
    return torch.from_numpy(np.asarray(a, order="C")).to(device=device,
                                                          dtype=dtype)


@dataclasses.dataclass(frozen=True)
class PrecisionScheme:
    name: str
    matrix_dtype: torch.dtype    # storage dtype of A's nonzero values
    spmv_in_dtype: torch.dtype   # x as consumed by the SpMV
    spmv_acc_dtype: torch.dtype  # multiply/accumulate dtype inside the SpMV
    vector_dtype: torch.dtype    # main-loop vectors (r, p, x, z, ap), scalars

    @property
    def host_matrix_dtype(self) -> np.dtype:
        """numpy dtype the host stackers pack values at (bf16:
        :data:`BF16_CARRIER`, the bit patterns)."""
        return _HOST[self.matrix_dtype]

    @property
    def matrix_bytes(self) -> int:
        return self.matrix_dtype.itemsize

    @property
    def vector_bytes(self) -> int:
        return self.vector_dtype.itemsize

    def nonzero_stream_bytes(self, index_bytes: int = 2) -> int:
        """Bytes per nonzero in the matrix stream: one value at
        ``matrix_dtype`` plus one local column index (int16 while the
        bucketed row count stays under 2^15, int32 beyond; pass the real
        width, :func:`repro_torch.sparse.stacking.index_bytes_for`).  The
        row index is the lane position, so it costs nothing; padding is
        measured on the stacked arrays (``stream_bytes_per_nnz()``), not
        modelled here."""
        return self.matrix_bytes + index_bytes


_f64, _f32, _bf16 = torch.float64, torch.float32, torch.bfloat16

SCHEMES = {
    "fp64":     PrecisionScheme("fp64",     _f64,  _f64,  _f64, _f64),
    "mixed_v1": PrecisionScheme("mixed_v1", _f32,  _f32,  _f32, _f64),
    "mixed_v2": PrecisionScheme("mixed_v2", _f32,  _f32,  _f64, _f64),
    "mixed_v3": PrecisionScheme("mixed_v3", _f32,  _f64,  _f64, _f64),
    "tpu_fp32": PrecisionScheme("tpu_fp32", _f32,  _f32,  _f32, _f32),
    "tpu_v1":   PrecisionScheme("tpu_v1",   _bf16, _bf16, _bf16, _f32),
    "tpu_v2":   PrecisionScheme("tpu_v2",   _bf16, _bf16, _f32, _f32),
    "tpu_v3":   PrecisionScheme("tpu_v3",   _bf16, _f32,  _f32, _f32),
}


def get_scheme(name_or_scheme) -> PrecisionScheme:
    if isinstance(name_or_scheme, PrecisionScheme):
        return name_or_scheme
    try:
        return SCHEMES[name_or_scheme]
    except KeyError:
        raise ValueError(
            f"unknown precision scheme {name_or_scheme!r}; "
            f"available: {sorted(SCHEMES)}") from None
