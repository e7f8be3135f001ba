"""idle_launch_pct.single: the share of the traced stretch's device idle
time that the host spent enqueueing an iteration: each idle gap between
the device's busy intervals, placed by its midpoint, counts where it
falls inside one of the port's ``solve.iter`` span records, each record
placed at its perf_counter time less the stretch's start (the benchmark's
own spans are placed so).  None without a trace or records.

The stretch's device times count from its first operation, which starts
later than the host's start of the stretch: on an H100 under the
profiler 0.2-1.1 ms, up to more than an iteration (0.3-0.6 ms), so gaps
placed so would land in the wrong iteration and the share would read the
records' own share of the time; and in about half the profiler sessions
the device's timestamps drift against the host's clock (-300 to +290 us
a second measured).  So each device time is placed by the ``rr`` read
nearest before it: a read's device-to-host copy runs while its
``solve.rr_read`` record is open, and each copy is centred in its
record."""
import bisect

#: Device operations of a host read: its copy on the card, the read
#: itself where the profiled device is the CPU.
READS = ("Memcpy DtoH", "aten::_local_scalar_dense")
#: The most one read moves the placement: the device clock's drift over
#: an iteration is a fraction of a microsecond, the next record's
#: distance hundreds.
STEP_S = 50e-6


def records(profile, name):
    """The port's ``name`` span records of the stretch as sorted
    ``(start_s, end_s)`` from its host start, or None where the program
    keeps no records."""
    from repro_torch.core import metrics
    spans = getattr(metrics.solver_metrics(), "spans", None)
    if spans is None:
        return None
    placed = ((t0 / 1e9 - profile.t0, t1 / 1e9 - profile.t0)
              for rec in spans() if rec and rec[0] == name
              for t0, t1 in [rec[1:3]])
    return sorted((s, e) for s, e in placed
                  if e >= 0 and s <= profile.window_s)


def inside(spans, starts, t) -> bool:
    """Whether ``t`` lies in one of the disjoint sorted ``spans``."""
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and t <= spans[k][1]


def shift(copies, reads) -> float:
    """Seconds to add to the device times of the first ``copies`` (read
    copies' end times) to place them on the host's clock: of the shifts
    that put one of the first 32 in the middle of one of the first 32
    ``reads`` records, the one that puts the most of the first 256 inside
    read records."""
    starts = [s for s, _ in reads]

    def hits(d):
        return sum(inside(reads, starts, c + d) for c in copies[:256])

    return max(((s + e) / 2 - c for c in copies[:32] for s, e in reads[:32]),
               key=hits)


def placement(profile, reads):
    """``(copies, shifts)``: the read copies' device end times, and for
    each the seconds that place it, and the device times up to the next
    copy, on the host's clock.  From :func:`shift`, each copy in turn is
    centred in the read record nearest to it where that moves it less
    than ``STEP_S``; ``([0], [0])`` without copies or records."""
    copies = sorted(e for name, _, e in profile.ops
                    if any(r in name for r in READS))
    if not copies or not reads:
        return [0.0], [0.0]
    mids = [(s + e) / 2 for s, e in reads]
    d, shifts = shift(copies, reads), []
    for c in copies:
        k = bisect.bisect_left(mids, c + d)
        near = min(mids[max(k - 1, 0):k + 1], key=lambda m: abs(m - c - d))
        if abs(near - c - d) < STEP_S:
            d = near - c
        shifts.append(d)
    return copies, shifts


def share(profile, spans, copies, shifts):
    """The share (%) of ``profile``'s idle time whose gaps have their
    midpoints, placed by ``(copies, shifts)`` (:func:`placement`), in
    ``spans``; None without idle time."""
    starts = [s for s, _ in spans]
    idle = launch = edge = 0.0
    for s, e in profile.busy() + [[profile.window_s, profile.window_s]]:
        if s > edge:
            mid = (edge + s) / 2
            d = shifts[max(bisect.bisect_right(copies, mid) - 1, 0)]
            idle += s - edge
            if inside(spans, starts, mid + d):
                launch += s - edge
        edge = max(edge, e)
    return 100.0 * launch / idle if idle else None


def read(run):
    prof = run.profile
    if prof is None:
        return None
    spans = records(prof, "solve.iter")
    if not spans:
        return None
    return share(prof, spans,
                 *placement(prof, records(prof, "solve.rr_read")))
