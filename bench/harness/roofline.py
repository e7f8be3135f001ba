"""The yardstick of the kernels' roofline shares: the card's peaks and the
least work each kernel's inputs need.

The peaks are copied from ``src/repro_torch/roofline/model.py``'s ``H100``
(NVIDIA's H100 SXM data sheet, dense rates): 3.35 TB/s of HBM, 33.5
TFLOP/s fp64 and 66.9 TFLOP/s fp32 on the CUDA cores, which is where the
port's solver kernels compute (fp64 on the tensor cores, 66.9, is used by
none of them).  The bytes are the work the inputs need, never a stored
layout's padded slots: a SpMV reads each nonzero once at the scheme's
matrix dtype with its column index at int32, reads x once at the SpMV's
input dtype and writes y once at its output dtype, and does 2 flops a
nonzero.  So a layout that pads less reads as a gain, not as a moved
yardstick.
"""
from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "SCHEMES", "spmv_work",
           "vector_bytes", "bound_s"]

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 33.5e12, "float32": 66.9e12}
_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2}
INDEX_BYTES = 4

#: Callipepla's Table 1 (the port's ``core/precision.py``): the matrix's
#: dtype, the SpMV's x and y dtypes, and the solver vectors' dtype.
SCHEMES = {
    "fp64": ("float64", "float64", "float64", "float64"),
    "mixed_v1": ("float32", "float32", "float32", "float64"),
    "mixed_v2": ("float32", "float32", "float64", "float64"),
    "mixed_v3": ("float32", "float64", "float64", "float64"),
}

#: Vectors each solver-loop kernel reads or writes once: the dot reads two;
#: phase 2 reads r, ap and the diagonal and writes r'; phase 3 reads r',
#: the diagonal, p and x and writes p' and x'.
VECTOR_KERNEL_VECTORS = {"dot": 2, "phase2": 4, "phase3": 6}


def spmv_work(n: int, nnz: int, scheme: str) -> tuple:
    """``(bytes, flops)`` of one SpMV over a matrix of ``n`` rows and
    ``nnz`` nonzeros."""
    mat, x_in, y_out, _ = SCHEMES[scheme]
    nbytes = (nnz * (_BYTES[mat] + INDEX_BYTES)
              + n * (_BYTES[x_in] + _BYTES[y_out]))
    return nbytes, 2 * nnz


def vector_bytes(kernel: str, n: int, scheme: str) -> int:
    """Bytes one launch of a solver-loop vector kernel moves."""
    return VECTOR_KERNEL_VECTORS[kernel] * n * _BYTES[SCHEMES[scheme][3]]


def bound_s(nbytes: int, flops: int, acc_dtype: str) -> float:
    """The least time the card takes: the larger of bytes over the HBM
    rate and flops over the dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[acc_dtype])
