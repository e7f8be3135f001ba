"""admit_ms.engine: the mean host wall of a submit in the window (the
engine packs the matrix into a slot and runs the lane's warm-up)."""


def read(run):
    spans = run.span_list("admit")
    return sum(spans) / len(spans) * 1e3 if spans else None
