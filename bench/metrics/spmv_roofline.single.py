"""spmv_roofline.single: the single-system SpMV kernel's share of its
bound over the traced stretch: launches x the least time one SpMV of the
CSR's work takes (harness.roofline), over the kernels' device time.  Read
where the configuration has one matrix: with several, a launch's work is
not known."""
from harness.roofline import SCHEMES, bound_s, spmv_work


def read(run):
    ks = run.kernels("spmv_ellpack")
    if not ks or len(run.inputs.matrices) != 1:
        return None
    a, scheme = run.inputs.matrices[0], run.config["scheme"]
    nbytes, flops = spmv_work(a.n, a.nnz, scheme)
    bound = len(ks) * bound_s(nbytes, flops, SCHEMES[scheme][2])
    return 100.0 * bound / sum(e - s for _, s, e in ks)
