"""idle_pct.single: the share of time the device would sit idle in the
untraced loop: 1 - the device's busy time over the traced stretch, over
what the stretch's host spans take untraced (each at the window's mean
for its name).  The profiler slows the host's launches (on an H100, one
ecology2 solve took about 1.8 s traced against 1.0 s untraced) and not
the device's operations, so the traced stretch's own idle share would count
the profiler's overhead as idle time."""


def read(run):
    untraced = run.traced_untraced_s()
    if not untraced:
        return None
    return 100.0 * (1.0 - run.profile.busy_s() / untraced)
