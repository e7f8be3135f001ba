"""Three-term roofline model over H100 constants (the port of
:mod:`repro.roofline.model`, whose ``V5E`` constant this one replaces).

    compute    = FLOPs / peak FLOP/s of the dtype      (per device)
    memory     = bytes / HBM bandwidth                 (per device)
    collective = wire bytes / (links × link bandwidth) (per device)

The counts come from :func:`repro_torch.roofline.torch_cost.count_torch`
(an eager step, every iteration seen) or, for the solver, from
:func:`solver_terms` (the paper's VSR accounting, analytic).
``MODEL_FLOPS`` = 6·N·D for a train step, 2·N a token forward, gives the
useful-compute ratio that catches recompute and padding waste.

The peaks are named once here; ``chip_smoke.py`` prices every kernel
bound with them too.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.precision import PrecisionScheme, get_scheme
from repro_torch.core.vsr import schedule
from repro_torch.sparse.stacking import index_bytes_for

__all__ = ["H100", "Hardware", "RooflineTerms", "roofline_terms",
           "model_flops_train", "model_flops_decode", "solver_terms",
           "solver_flops_per_iter", "solver_bytes_per_iter"]

#: the names a dtype goes by (the reference's, and torch's)
_ALIASES = {"bf16": "bf16", "bfloat16": "bf16",
            "f32": "fp32", "fp32": "fp32", "float32": "fp32",
            "f64": "fp64", "fp64": "fp64", "float64": "fp64",
            "fp64_tc": "fp64_tc", "tf32": "tf32"}


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One device's peaks.  ``peaks`` holds the FLOP/s of each dtype other
    than bf16 as ``(name, rate)`` pairs; a dtype without a peak raises."""

    name: str
    peak_bf16_flops: float       # per device, dense
    hbm_bw: float                # bytes/s per device
    ici_link_bw: float           # bytes/s per link, each way
    ici_links: int               # links per device
    hbm_bytes: float             # capacity per device
    peaks: Tuple[Tuple[str, float], ...] = ()

    def peak_flops(self, dtype: str = "bf16") -> float:
        table = {"bf16": self.peak_bf16_flops, **dict(self.peaks)}
        key = _ALIASES.get(str(dtype).split(".")[-1])
        if key not in table:
            raise ValueError(f"{self.name}: no peak for dtype {dtype!r}; "
                             f"has {sorted(table)}")
        return table[key]


#: NVIDIA H100 SXM5 (NVIDIA's data sheet, dense, without sparsity): bf16
#: on the tensor cores; fp32 off them (PyTorch's own fp32 matmuls run with
#: TF32 off wherever the port is measured); ``tf32`` on the tensor cores
#: (the fp32 ``flash_attention`` kernel's three TF32 products); fp64 off the
#: tensor cores (the port's kernels use none) and, as ``fp64_tc``, on them;
#: 18 NVLink 4 links of 25 GB/s each way.
H100 = Hardware(name="h100_sxm", peak_bf16_flops=989.4e12, hbm_bw=3.35e12,
                ici_link_bw=25e9, ici_links=18, hbm_bytes=80e9,
                peaks=(("fp32", 66.9e12), ("fp64", 33.5e12),
                       ("fp64_tc", 66.9e12), ("tf32", 494.7e12)))


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float                 # per-device counted flops
    hbm_bytes: float             # per-device counted bytes
    wire_bytes: float            # per-device collective bytes
    model_flops: Optional[float] = None   # 6·N·D useful flops (global)
    chips: int = 1
    peak_flops: Optional[float] = None    # the FLOP/s compute_s used

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Roofline step time (max of the three overlappable terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> Optional[float]:
        """MODEL_FLOPS / (chips × counted FLOPs): how much of the counted
        compute is useful (recompute, padding, redundancy show here)."""
        if self.model_flops is None or self.flops == 0:
            return None
        return self.model_flops / (self.chips * self.flops)

    @property
    def mfu_at_roofline(self) -> Optional[float]:
        """Model FLOPs utilization if the step ran at its roofline bound,
        against the peak these terms were priced with (the reference
        divides by ``V5E``'s bf16 peak whatever hardware was passed)."""
        if (self.model_flops is None or self.bound_s == 0
                or not self.peak_flops):
            return None
        per_chip = self.model_flops / self.chips
        return per_chip / (self.bound_s * self.peak_flops)

    def as_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes, "model_flops": self.model_flops,
            "useful_fraction": self.useful_fraction,
            "mfu_at_roofline": self.mfu_at_roofline, "chips": self.chips,
            "peak_flops": self.peak_flops,
        }


def roofline_terms(cost: Dict, wire_bytes: float, *, hw: Hardware = H100,
                   dtype: str = "bf16", chips: int = 1,
                   model_flops: Optional[float] = None) -> RooflineTerms:
    """``cost`` holds ``"flops"`` and ``"bytes accessed"`` per device."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    peak = hw.peak_flops(dtype)
    return RooflineTerms(
        compute_s=flops / peak,
        memory_s=hbm / hw.hbm_bw,
        collective_s=wire_bytes / (hw.ici_links * hw.ici_link_bw),
        flops=flops, hbm_bytes=hbm, wire_bytes=wire_bytes,
        model_flops=model_flops, chips=chips, peak_flops=peak)


def model_flops_train(n_params: int, n_tokens: int) -> float:
    """6·N·D — fwd+bwd useful flops for one step over n_tokens."""
    return 6.0 * n_params * n_tokens


def model_flops_decode(n_params: int, batch: int) -> float:
    """2·N per generated token (fwd only), × batch."""
    return 2.0 * n_params * batch


# ------------------------------------------------------------ the solver
def solver_flops_per_iter(n: int, nnz: int) -> int:
    """The paper's count for one JPCG iteration: one SpMV (2·nnz), three
    dots and three axpys (2·n each) and one divide (n)."""
    return 2 * nnz + 13 * n


def solver_bytes_per_iter(n: int, nnz: int, scheme,
                          matrix_bytes: Optional[int] = None) -> int:
    """Device bytes one JPCG iteration must move under the min-traffic
    VSR schedule (13 vector accesses of n at ``vector_dtype``) plus the
    matrix stream: by default a value and one column index per nonzero,
    the index as wide as the bucketed layout packs it for this n; or
    ``matrix_bytes``, the stream of a stored layout's slots (such as
    ``EllpackMatrix.stream_bytes``)."""
    scheme = get_scheme(scheme)
    s = schedule(policy="min_traffic")
    vec = (s.n_reads + s.n_writes) * n * scheme.vector_bytes
    if matrix_bytes is None:
        matrix_bytes = nnz * scheme.nonzero_stream_bytes(
            index_bytes=index_bytes_for(n))
    return vec + matrix_bytes


def solver_terms(a, scheme, *, hw: Hardware = H100,
                 matrix_bytes: Optional[int] = None) -> RooflineTerms:
    """Roofline terms of one JPCG iteration on ``a`` (anything with
    ``shape`` and ``nnz``, such as a CSR matrix): the paper's flops over
    the peak of the scheme's vector dtype, :func:`solver_bytes_per_iter`
    (``matrix_bytes`` passed on) over HBM bandwidth; no collective.
    Every flop is useful."""
    scheme: PrecisionScheme = get_scheme(scheme)
    n, nnz = int(a.shape[0]), int(a.nnz)
    flops = solver_flops_per_iter(n, nnz)
    return roofline_terms(
        {"flops": flops,
         "bytes accessed": solver_bytes_per_iter(n, nnz, scheme,
                                                 matrix_bytes)},
        0.0, hw=hw, dtype=str(scheme.vector_dtype), model_flops=flops)
