"""rr_wait_pct.single: the share of the solver loop's host time spent
blocked on the predicate's ``rr`` read, over the traced stretch: the
port's ``solve.rr_read`` span time over it plus ``solve.iter``'s
(enqueueing an iteration).  Higher is better: a loop that stops being
launch-bound waits on the device instead."""
from pathlib import Path

from harness.spec import load_module

_syncs = load_module(Path(__file__).with_name(
    "host_syncs_per_iter.single.py"))


def read(run):
    c = _syncs.solver_counters()
    wait, launch = c.get("solve.rr_read.ns"), c.get("solve.iter.ns")
    if wait is None or launch is None or not wait + launch:
        return None
    return 100.0 * wait / (wait + launch)
