"""tick_ms.engine: the mean host wall of an engine step in the window
(one chunk of the stream VM over every slot, and the harvest)."""


def read(run):
    spans = run.span_list("tick")
    return sum(spans) / len(spans) * 1e3 if spans else None
