"""Host-side sparse substrate of the port: numpy copies of
:mod:`repro.sparse` (CSR, banked ELL, banked ELLPACK, the batched
stackers, the synthetic problem generators and the Table 3 suite,
row partitioning and MatrixMarket I/O).  Exports the reference's names
and the port's own ELLPACK ones."""
from repro_torch.sparse.csr import (CSRMatrix, csr_from_coo, csr_spmv,
                                    csr_to_dense)
from repro_torch.sparse.bell import (BellMatrix, bell_spmv_reference,
                                     csr_to_bell)
from repro_torch.sparse.ellpack import (EllpackMatrix, csr_to_ellpack,
                                        ellpack_spmv_reference)
from repro_torch.sparse.generators import (benchmark_suite,
                                           diag_dominant_spd, poisson_2d,
                                           poisson_3d, powerlaw_spd,
                                           random_spd, suite_metadata,
                                           tridiagonal_spd)
from repro_torch.sparse.mtx import read_mtx, write_mtx
from repro_torch.sparse.partition import PartitionedMatrix, partition_rows
from repro_torch.sparse.stacking import (StackedBell, StackedEllpack,
                                         StackedFlat, StackedRowEll,
                                         StackedSell, bucket_up,
                                         choose_layout, flatten_bell,
                                         index_bytes_for, index_dtype,
                                         pad_bell, pad_ellpack, stack_bell,
                                         stack_ellpack, stack_flat,
                                         stack_rowell, stack_sell,
                                         rowell_padding_ratio)

__all__ = [
    "CSRMatrix", "csr_from_coo", "csr_to_dense", "csr_spmv",
    "BellMatrix", "csr_to_bell", "bell_spmv_reference",
    "EllpackMatrix", "csr_to_ellpack", "ellpack_spmv_reference",
    "poisson_2d", "poisson_3d", "random_spd", "diag_dominant_spd",
    "powerlaw_spd", "tridiagonal_spd", "benchmark_suite", "suite_metadata",
    "read_mtx", "write_mtx",
    "partition_rows", "PartitionedMatrix",
    "bucket_up", "pad_bell", "pad_ellpack", "stack_bell", "stack_ellpack",
    "stack_rowell", "stack_sell", "StackedBell", "StackedEllpack",
    "StackedRowEll", "StackedSell", "index_dtype", "index_bytes_for",
    "rowell_padding_ratio", "choose_layout",
    "flatten_bell", "stack_flat", "StackedFlat",
]
