"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: :mod:`~repro_torch.kernels.spmv` (SELL and ELLPACK SpMV),
:mod:`~repro_torch.kernels.dot` (dot, dot3) and
:mod:`~repro_torch.kernels.fused_phase` (JPCG phases 2 and 3);
:mod:`~repro_torch.kernels.ops` binds them to the single-system solver."""
