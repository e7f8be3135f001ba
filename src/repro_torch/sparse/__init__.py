"""Host-side sparse substrate of the port: numpy copies of the parts of
:mod:`repro.sparse` the solvers use (CSR, banked ELL, banked ELLPACK,
the batched stackers, the synthetic problem generators and MatrixMarket
I/O)."""
from repro_torch.sparse.bell import (BellMatrix, bell_spmv_reference,
                                     csr_to_bell)
from repro_torch.sparse.csr import CSRMatrix, csr_from_coo, csr_to_dense
from repro_torch.sparse.ellpack import EllpackMatrix, csr_to_ellpack
from repro_torch.sparse.mtx import read_mtx, write_mtx
from repro_torch.sparse.generators import (diag_dominant_spd, poisson_2d,
                                           poisson_3d, powerlaw_spd,
                                           random_spd, tridiagonal_spd)
from repro_torch.sparse.stacking import (StackedEllpack, StackedRowEll,
                                         StackedSell, bucket_up,
                                         choose_layout, index_dtype,
                                         stack_ellpack, stack_rowell,
                                         stack_sell)

__all__ = ["BellMatrix", "bell_spmv_reference", "csr_to_bell", "CSRMatrix",
           "csr_from_coo", "csr_to_dense", "EllpackMatrix", "csr_to_ellpack",
           "diag_dominant_spd", "poisson_2d", "poisson_3d", "powerlaw_spd",
           "random_spd", "tridiagonal_spd", "StackedEllpack",
           "StackedRowEll", "StackedSell", "bucket_up", "choose_layout",
           "index_dtype", "stack_ellpack", "stack_rowell", "stack_sell",
           "read_mtx", "write_mtx"]
