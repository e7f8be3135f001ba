"""admit_pack_ms.engine: host packing a submit over the traced stretch:
the port's ``admit.pack`` span time (CSR to padded ELLPACK, the
diagonal, the padded b and x0) over its ``submit`` spans, from the
counters SolverEngine.metrics() carries while tracing is on.  None where
the program records no spans."""


def per_submit_ms(counters, *names, less=()):
    """The ``.ns`` counters of spans ``names``, less those of ``less``
    (absent: 0), in ms a ``submit``; None without a submit or one of
    ``names``."""
    n = counters.get("submit.n")
    if not n or any(f"{k}.ns" not in counters for k in names):
        return None
    ns = (sum(counters[f"{k}.ns"] for k in names)
          - sum(counters.get(f"{k}.ns", 0) for k in less))
    return ns / n / 1e6


def read(run):
    return per_submit_ms(run.counters, "admit.pack")
