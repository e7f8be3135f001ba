"""Hand-written Hopper kernels of the port (see :mod:`repro_torch.kernels.spmv`)."""
