"""systems_per_s: systems the window harvested CONVERGED, over its
length (an answer judged wrong fails the run)."""


def read(run):
    done = [a for a in run.window_answers()
            if a.result.status == "CONVERGED"]
    return len(done) / run.window_s if run.window_s else None
