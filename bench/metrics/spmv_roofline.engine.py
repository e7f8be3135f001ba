"""spmv_roofline.engine: the batched SpMV kernels' share of their bound
over the traced stretch: the engine's spmv_calls counter (lane SpMVs
that did work) x the least time one lane's CSR work takes, over the
device time of every batched SpMV launch (dead lanes ride along).  Read
where the configuration has one matrix."""
from harness.roofline import SCHEMES, bound_s, spmv_work


def read(run):
    ks = run.kernels("spmv_ellpack", "spmv_sell")
    calls = run.counters.get("spmv_calls")
    if not ks or not calls or len(run.inputs.matrices) != 1:
        return None
    a, scheme = run.inputs.matrices[0], run.config["scheme"]
    nbytes, flops = spmv_work(a.n, a.nnz, scheme)
    bound = calls * bound_s(nbytes, flops, SCHEMES[scheme][2])
    return 100.0 * bound / sum(e - s for _, s, e in ks)
