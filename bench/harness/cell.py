"""One run of one cell: set-up, the window, the traced stretch, the check
that decides ``correct``, and the result line.

The profiler helper is adapted from ``chip_smoke.py``'s
``device_profile`` (device activity only: operator events would repeat
their kernels' time and cost seconds to sort); it keeps each device
operation's interval, so the busy time is their union and the idle gaps
can be named by the benchmark's own span the host was in.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, List, Optional

import torch

from harness.spec import Cell
from harness.traffic import TRACED, WINDOW, Answer, drive, sync

__all__ = ["Profile", "Run", "profile_window", "run_cell"]

GRACE_S = 60.0                   # the wait past the close for due answers


@dataclasses.dataclass
class Profile:
    """A traced stretch: its host start, its length, and every device
    operation ``(name, start_s, end_s)`` from its start."""

    t0: float
    window_s: float
    ops: List[tuple]

    def busy(self) -> List[tuple]:
        """The union of the operations' intervals, as merged intervals."""
        merged: List[list] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, 0.0), min(e, self.window_s)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            elif e > s:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())


def profile_window(fn, device) -> Profile:
    """Run ``fn`` under ``torch.profiler``, tracing the device alone (the
    CPU's operators where the device is the CPU, for the tests)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        sync(device)
        t0 = time.perf_counter()
        torch.zeros(1, device=device)     # the first operation, at t0
        fn()
        sync(device)
        window_s = time.perf_counter() - t0
    want = DeviceType.CUDA if cuda else DeviceType.CPU
    ev = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in prof.events() if e.device_type == want)
    origin = ev[0][0] if ev else 0.0
    return Profile(t0=t0, window_s=window_s,
                   ops=[(name, (s - origin) / 1e6, (e - origin) / 1e6)
                        for s, e, name in ev])


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (``bench/metrics/<name>.py``)."""

    cell: str
    config: dict
    inputs: Any                  # the program's (bench/programs/<name>.py)
    setup_s: float
    window_s: float
    answers: List[Answer]
    spans: Dict[str, Dict[str, List[float]]]   # by phase, then by name
    counters: Dict[str, int]
    profile: Optional[Profile]

    def window_answers(self) -> List[Answer]:
        return [a for a in self.answers if a.phase == WINDOW]

    def span_list(self, name: str, phase: str = WINDOW) -> List[float]:
        """The durations of the host spans ``name`` of ``phase``."""
        return self.spans.get(phase, {}).get(name, [])

    def traced_untraced_s(self) -> Optional[float]:
        """What the traced stretch's host work takes untraced: each of its
        spans at the window's mean for its name; None without a trace."""
        if self.profile is None:
            return None
        total = 0.0
        for name, spans in self.spans.get(TRACED, {}).items():
            same = self.span_list(name)
            if not same:
                return None
            total += len(spans) * sum(same) / len(same)
        return total or None

    def kernels(self, *parts: str) -> Optional[List[tuple]]:
        """The traced operations whose name holds one of ``parts``; None
        without a trace."""
        if self.profile is None:
            return None
        return [o for o in self.profile.ops if any(p in o[0] for p in parts)]


def _breakdown(profile: Profile, host: List[tuple]) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by the benchmark span the host was in."""
    by_op: Dict[str, float] = {}
    for name, s, e in profile.ops:
        by_op[name[:120]] = by_op.get(name[:120], 0.0) + (e - s)
    spans = sorted((t0 - profile.t0, t1 - profile.t0, name)
                   for name, t0, t1 in host
                   if t1 >= profile.t0 and t0 <= profile.t0 + profile.window_s)
    gaps: Dict[str, list] = {}
    edge = 0.0
    for s, e in profile.busy() + [[profile.window_s, profile.window_s]]:
        if s > edge:
            mid = (edge + s) / 2
            label = next((n for t0, t1, n in spans if t0 <= mid <= t1),
                         "between calls")
            g = gaps.setdefault(label, [0.0, 0])
            g[0] += s - edge
            g[1] += 1
        edge = max(edge, e)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[f"{k} ({n} gaps)", v] for k, (v, n) in idle]}


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device, t_start: float, program=None,
             grace_s: float = GRACE_S) -> dict:
    """One run of ``cell``; returns the result line's object (``checks``
    last).  ``program`` defaults to the cell's program's ``Port``."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    mix = cell.traffic
    inputs = cell.program.make_inputs(cell.config, seed, device, cell.root)
    program = (program or cell.program.Port)(cell.config, mix, device)
    if cuda:
        torch.zeros(1, device=device)     # the allocator, before its reset
        torch.cuda.reset_peak_memory_stats(device)
    profile = (lambda fn: profile_window(fn, device)) if trace else None
    loop, t_window, profiled = drive(cell.entry, program, inputs, mix,
                                     device, seconds=seconds,
                                     profile=profile, grace_s=grace_s)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    correct, failed, checks = cell.program.judge(
        cell, inputs, loop.answers, loop.missing, seed, device)
    run = Run(cell=cell.name, config=cell.config, inputs=inputs,
              setup_s=t_window - t_start, window_s=loop.window_s,
              answers=loop.answers, spans=loop.spans,
              counters=loop.counters, profile=profiled)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.readers[m["name"]](run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(loop.answers) + loop.missing,
           "failed": failed, "metrics": metrics, "device": dev}
    if profiled is not None:
        dev["busy_s"] = profiled.busy_s()
        dev["window_s"] = profiled.window_s
        out["breakdown"] = _breakdown(profiled, loop.host)
    out["window"] = {"seconds": loop.window_s,
                     "answers": len(run.window_answers()),
                     "span_mean_ms": {k: sum(v) / len(v) * 1e3 for k, v in
                                      loop.spans.get(WINDOW, {}).items()}}
    out["checks"] = checks
    return out
