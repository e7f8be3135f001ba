"""solve_ms: the window's length over the solves it completed."""


def read(run):
    done = run.window_answers()
    return run.window_s / len(done) * 1e3 if done else None
