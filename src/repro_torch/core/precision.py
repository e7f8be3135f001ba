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

The TPU tier (``tpu_*``, one level down, bf16 values) keeps its rows so
names resolve the same way, but packing bf16 values at rest needs a
numpy bf16 type the port does not carry yet: :attr:`host_matrix_dtype`
raises ``NotImplementedError`` for it, which stops such a scheme at
stacking.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["PrecisionScheme", "get_scheme", "SCHEMES"]

_HOST = {torch.float64: np.dtype(np.float64),
         torch.float32: np.dtype(np.float32)}


@dataclasses.dataclass(frozen=True)
class PrecisionScheme:
    name: str
    matrix_dtype: torch.dtype    # storage dtype of A's nonzero values
    spmv_in_dtype: torch.dtype   # x as consumed by the SpMV
    spmv_acc_dtype: torch.dtype  # multiply/accumulate dtype inside the SpMV
    vector_dtype: torch.dtype    # main-loop vectors (r, p, x, z, ap), scalars

    @property
    def host_matrix_dtype(self) -> np.dtype:
        """numpy dtype the host stackers pack values at."""
        try:
            return _HOST[self.matrix_dtype]
        except KeyError:
            raise NotImplementedError(
                f"scheme {self.name!r} packs values at {self.matrix_dtype}, "
                "which the host stackers cannot hold yet") from None


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
