"""iter_ms.single: the window's solve walls over their iterations."""


def read(run):
    done = run.window_answers()
    its = sum(a.result.iterations for a in done)
    return sum(a.wall_s for a in done) / its * 1e3 if its else None
