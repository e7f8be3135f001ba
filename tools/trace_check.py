"""Checks of the port's spans on the card, at the benchmark's ecology2 size.

    python3 tools/trace_check.py --seed <n>

from the root of the repository, on a CUDA device.  Prints one JSON line
a reading:

* ``flags``: whether a CUDA-only ``torch.profiler`` session turns tracing
  on (``torch.autograd.profiler._is_profiler_enabled`` and
  ``torch._C._autograd._profiler_enabled()``);
* ``pair``: ``jpcg_solve`` with tracing off and on (``enable_tracing``,
  no profiler), interleaved on the same right-hand sides: ``iter_ms``,
  and with tracing on the loop's split (``rr_wait_pct``,
  ``host_syncs_per_iter``, the share of ``solve`` that ``solve.iter``
  and ``solve.rr_read`` cover);
* ``profiled``: the same split in PROFILED CUDA-only profiler sessions,
  and the shared clock: each ``solve.rr_read`` record mapped through
  ``Metrics.clock`` against the device-to-host copy it waited for (the
  one whose runtime call the record holds), the device timestamps'
  drift against the host's, where the first device operation lands
  against the stretch's host start, and ``idle_launch_pct.single``'s
  placement of the device times;
* ``engine``: the engine cell's traced stretch as the benchmark runs it
  (``bench/harness``): the benchmark's own ``admit`` and ``tick`` spans
  against the port's ``submit`` and ``step``, and what their children
  cover; then REPEATS more stretches with ``enable_tracing`` and no
  profiler, for the split of more admissions.
"""
import argparse
import bisect
import json
import statistics
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

import torch  # noqa: E402

from harness.cell import Profile, profile_window  # noqa: E402
from harness.spec import load_cell, load_module  # noqa: E402
from harness.traffic import TRACED, drive, sync  # noqa: E402
from repro_torch.core import metrics as M  # noqa: E402

SUBMIT_CHILDREN = ("submit.harvest", "admit.pack", "admit.grow",
                   "admit.copy", "admit.warmup")
STEP_CHILDREN = ("step.account", "step.vm", "step.harvest", "step.compact")
PAIRS = 8                        # solves with tracing off, and on, each
PROFILED = 3                     # profiler sessions of one solve each
SECONDS = 15.0                   # the engine's window before its stretches
REPEATS = 4                      # engine stretches with enable_tracing


def emit(kind, **kw):
    print(json.dumps({"reading": kind, **kw}), flush=True)


def loop_split(c: dict) -> dict:
    """The solver loop's split from solver counters ``c``."""
    it, rr, solve = c["solve.iter.ns"], c["solve.rr_read.ns"], c["solve.ns"]
    return {"rr_wait_pct": 100.0 * rr / (it + rr),
            "loop_cover_pct": 100.0 * (it + rr) / solve,
            "host_syncs_per_iter": c["host_syncs"] / c["solve.iter.n"],
            "solve_ms": solve / c["solve.n"] / 1e6}


def check_flags(dev):
    from torch.autograd import profiler
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev)
        inside = (profiler._is_profiler_enabled,
                  torch._C._autograd._profiler_enabled(), M.tracing())
    emit("flags", inside=inside, after=M.tracing(),
         torch=torch.__version__, cuda=torch.version.cuda)


def pairs(port, op, inputs, dev):
    """PAIRS pairs of solves, tracing off and on in turns, each pair on
    one b."""
    for k in range(PAIRS):
        _, b = inputs.request(k, dev)
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            M.reset_solver_metrics()
            M.enable_tracing(on)
            sync(dev)
            t0 = time.perf_counter()
            res = port.solve(op, b)
            sync(dev)
            wall = time.perf_counter() - t0
            M.enable_tracing(False)
            out = {"k": k, "on": on, "iterations": res.iterations,
                   "iter_ms": wall / res.iterations * 1e3}
            if on:
                out.update(loop_split(M.solver_metrics().snapshot()))
            emit("pair", **out)


def profiled(port, op, inputs, dev, k):
    """A solve under a CUDA-only profiler session, as the benchmark's
    stretch runs it; the shared clock and the reader's placement."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    M.reset_solver_metrics()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync(dev)
        t0 = time.perf_counter_ns()
        torch.zeros(1, device=dev)          # the first operation, at t0
        port.solve(op, inputs.request(100 + k, dev)[1])
        sync(dev)
        window_s = (time.perf_counter_ns() - t0) / 1e9
    m = M.solver_metrics()
    perf0, wall0 = m.clock

    def wall(t):
        return t - perf0 + wall0

    events = prof.profiler.kineto_results.events()
    ev = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                for e in events if e.device_type() == DeviceType.CUDA)
    copies = {e.correlation_id(): e.start_ns() + e.duration_ns()
              for e in events if "Memcpy DtoH" in e.name()}
    calls = sorted((e.start_ns(), e.correlation_id()) for e in events
                   if e.name() == "cudaMemcpyAsync"
                   and e.correlation_id() in copies)
    reads = [r for r in m.spans() if r and r[0] == "solve.rr_read"]
    # each read's copy: the one its runtime call (inside the record, on
    # the profiler's host clock) issued
    opened = [wall(r[1]) for r in reads]
    margins, lags, at = [], [], []
    for start, cid in calls:
        j = bisect.bisect_right(opened, start) - 1
        if j >= 0 and start <= wall(reads[j][2]):
            margins.append(wall(reads[j][2]) - copies[cid])
            lags.append(start - opened[j])
            at.append((opened[j] - opened[0]) / 1e9)
    # the reader's placement, on the stretch as the harness keeps it
    fe = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in prof.events() if e.device_type == DeviceType.CUDA)
    stretch = Profile(t0=t0 / 1e9, window_s=window_s, ops=[
        (name, (s - fe[0][0]) / 1e6, (e - fe[0][0]) / 1e6)
        for s, e, name in fe])
    reader = load_module(ROOT / "bench" / "metrics"
                         / "idle_launch_pct.single.py")
    copy_ends, shifts = reader.placement(
        stretch, reader.records(stretch, "solve.rr_read"))
    iters = reader.records(stretch, "solve.iter")
    emit("profiled", session=k, **loop_split(m.snapshot()),
         reads=len(reads), copies_of_reads=len(margins),
         copy_ends_by_record_end_pct=100.0 * sum(x >= 0 for x in margins)
         / max(1, len(margins)),
         record_end_minus_copy_end_us=spread_us(margins),
         device_drift_us_per_s=slope(at, [x / 1e3 for x in margins]),
         call_start_minus_record_start_us=spread_us(lags),
         first_device_op_after_t0_us=(ev[0][0] - wall(t0)) / 1e3,
         reader_shift_us=[shifts[0] * 1e6, shifts[-1] * 1e6],
         idle_launch_pct={
             "placed": reader.share(stretch, iters, copy_ends, shifts),
             "unplaced": reader.share(stretch, iters, [0.0], [0.0])})


def slope(xs, ys):
    """The least-squares slope of ``ys`` over ``xs``; None below two."""
    if len(xs) < 2:
        return None
    mx, my = statistics.mean(xs), statistics.mean(ys)
    return (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
            / sum((x - mx) ** 2 for x in xs))


def spread_us(ns):
    """Quartiles, least and most of ``ns`` (ns), in us; None below two."""
    if len(ns) < 2:
        return None
    return [x / 1e3 for x in statistics.quantiles(ns, n=4)
            + [min(ns), max(ns)]]


def engine(seed, dev):
    """The engine cell's traced stretch as the benchmark drives it, after
    a SECONDS window, then REPEATS more with enable_tracing alone."""
    cell = load_cell("ecology2.engine_stream", ROOT)
    inputs = cell.program.make_inputs(cell.config, seed, dev, cell.root)
    program = cell.program.Port(cell.config, cell.traffic, dev)
    entries = []

    class Entry(cell.entry.Entry):
        def __init__(self, *a):
            super().__init__(*a)
            entries.append(self)

    def mark(e):
        return e.counters(), {k: len(v) for k, v in
                              e.loop.spans.get(TRACED, {}).items()}

    def since(e, before):
        c0, n0 = before
        spans = {k: v[n0.get(k, 0):]
                 for k, v in e.loop.spans.get(TRACED, {}).items()}
        return spans, {k: v - c0.get(k, 0) for k, v in e.counters().items()}

    def stretches(fn):
        e = entries[0]
        before = mark(e)
        prof = profile_window(fn, dev)
        summarize("engine_profiled", *since(e, before),
                  prof.busy_s() / prof.window_s)
        before = mark(e)
        M.enable_tracing(True)
        for _ in range(REPEATS):
            fn()
        M.enable_tracing(False)
        summarize("engine_enable_tracing", *since(e, before), None)
        return prof

    drive(types.SimpleNamespace(Entry=Entry), program, inputs, cell.traffic,
          dev, seconds=SECONDS, profile=stretches)


def summarize(kind, bench_spans, c, busy_share):
    def mean(xs):
        return sum(xs) / len(xs) * 1e3 if xs else None

    n = c.get("submit.n", 0)
    steps = c.get("step.n", 0)
    out = {"bench_admit_ms": mean(bench_spans.get("admit", [])),
           "bench_admits": len(bench_spans.get("admit", [])),
           "bench_tick_ms": mean(bench_spans.get("tick", [])),
           "busy_share": busy_share, "submits": n, "steps": steps}
    if n:
        out["submit_ms"] = c["submit.ns"] / n / 1e6
        for k in SUBMIT_CHILDREN:
            out[f"{k}_ms"] = c.get(f"{k}.ns", 0) / n / 1e6
        out["submit_cover_pct"] = 100.0 * sum(
            c.get(f"{k}.ns", 0) for k in SUBMIT_CHILDREN) / c["submit.ns"]
        for k in ("packed_nnz", "packed_bytes", "h2d_bytes"):
            out[k] = c.get(k, 0) / n
    if steps:
        out["step_ms"] = c["step.ns"] / steps / 1e6
        for k in STEP_CHILDREN:
            out[f"{k}_ms"] = c.get(f"{k}.ns", 0) / steps / 1e6
        out["host_syncs"] = c.get("host_syncs", 0)
        out["d2h_bytes"] = c.get("d2h_bytes", 0)
    emit(kind, **out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_check.py measures on a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    emit("device", name=torch.cuda.get_device_name(dev))
    check_flags(dev)
    cell = load_cell("ecology2.rhs_stream", ROOT)
    inputs = cell.program.make_inputs(cell.config, args.seed, dev, cell.root)
    port = cell.program.Port(cell.config, cell.traffic, dev)
    op = port.operator(inputs.matrices[0])
    port.solve(op, inputs.request(10_000, dev)[1])      # warm-up
    pairs(port, op, inputs, dev)
    for k in range(PROFILED):
        profiled(port, op, inputs, dev, k)
    op = None
    engine(args.seed, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
