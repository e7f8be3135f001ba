"""host_syncs_per_iter.single: blocking device-to-host reads an iteration
over the traced stretch: the port's ``host_syncs`` counter over its
``solve.iter`` spans (repro_torch.core.metrics.solver_metrics(), whose
traced counters move only while the profiler runs).  None where the
program has no such counters."""


def solver_counters():
    """The port's process-wide solver counters, as a dict."""
    from repro_torch.core.metrics import solver_metrics
    return solver_metrics().snapshot()


def read(run):
    c = solver_counters()
    iters = c.get("solve.iter.n")
    return c.get("host_syncs", 0) / iters if iters else None
