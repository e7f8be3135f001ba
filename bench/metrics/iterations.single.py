"""iterations.single: the mean of CGResult.iterations over the window's
solves."""


def read(run):
    done = run.window_answers()
    if not done:
        return None
    return sum(a.result.iterations for a in done) / len(done)
