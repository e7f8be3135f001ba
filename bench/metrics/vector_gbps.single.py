"""vector_gbps.single: the rate at which the solver loop's dot, phase-2
and phase-3 kernels move their vectors, each read or written once
(harness.roofline.vector_bytes), over their device time, in GB/s.

A rate and not a share of the HBM peak: at ecology2's size the loop's
vectors (8 MB each) are partly served from the 50 MB L2 (on an H100,
phase 2 alone read 104 % of the HBM bound), so no HBM roofline bounds them.  Read
where the configuration has one matrix."""
from harness.roofline import vector_bytes

KERNELS = {"dot": "dot_chunks", "phase2": "phase2_chunks",
           "phase3": "phase3_kernel"}


def read(run):
    if run.profile is None or len(run.inputs.matrices) != 1:
        return None
    n = run.inputs.matrices[0].n
    moved = busy = 0.0
    for kernel, symbol in KERNELS.items():
        ks = run.kernels(symbol)
        moved += len(ks) * vector_bytes(kernel, n, run.config["scheme"])
        busy += sum(e - s for _, s, e in ks)
    return moved / busy / 1e9 if busy else None
