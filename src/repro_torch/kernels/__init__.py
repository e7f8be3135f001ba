"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: :mod:`~repro_torch.kernels.spmv` (SELL and ELLPACK SpMV),
:mod:`~repro_torch.kernels.dot` (dot, dot3),
:mod:`~repro_torch.kernels.fused_phase` (JPCG phases 2 and 3) and
:mod:`~repro_torch.kernels.flash_attn` (:func:`flash_attention`, an entry
point of its own, as in the reference); :mod:`~repro_torch.kernels.ops`
binds the solver's kernels to the single-system solver, and its
:func:`~repro_torch.kernels.ops.launches` counts the launches of every
kernel of the port."""
from repro_torch.kernels.flash_attn import flash_attention

__all__ = ["flash_attention"]
