"""The one generator every traffic mix runs through.

A mix is a file of parameters, ``bench/traffic/<name>.json``.  Its
``entry`` names the client loop, a module ``bench/entries/<entry>.py``
whose ``Entry(program, inputs, mix, device, loop)`` sets itself up (what
it runs there is set-up) and then answers:

* ``run(until, phase)``: send requests and collect answers until
  ``until(now, answered)`` holds after an answer; every span and answer
  is marked ``phase``;
* ``drain(grace_s)``: collect what is still in flight, at most
  ``grace_s`` more, and set ``loop.missing`` to what never came;
* ``counters()``: the program's own counters; ``close()``.

The inputs are the program's (``bench/programs/<program>.py``): request
``k`` is the same for every run of a seed, whatever the order of draws.
The window opens after set-up and closes at the first answer at or after
``--seconds``, so a rate is taken over whole requests and all the time
between them.  With ``--trace 1`` the same loop runs on for the mix's
``profile_seconds`` under the profiler, after the window.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["derive_seed", "Answer", "Loop", "drive", "sync"]

#: The phases of a run, as spans and answers are marked.
SETUP, WINDOW, TRACED, DRAIN = "setup", "window", "traced", "drain"


def derive_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one stream of ``seed``'s inputs."""
    ss = np.random.SeedSequence([seed % 2 ** 64, *keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass
class Answer:
    k: int                  # the request
    result: Any             # what the program answered
    wall_s: float           # from the call or the submit to the answer
    phase: str


@dataclasses.dataclass
class Loop:
    """What the traffic did: its answers and the benchmark's spans."""

    answers: List[Answer] = dataclasses.field(default_factory=list)
    #: span durations by phase, then by span name
    spans: Dict[str, Dict[str, List[float]]] = dataclasses.field(
        default_factory=dict)
    host: List[tuple] = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    missing: int = 0
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)

    def span(self, name: str, t0: float, t1: float, phase: str) -> None:
        """Record a host span of ``phase``."""
        self.spans.setdefault(phase, {}).setdefault(name, []).append(t1 - t0)
        self.host.append((name, t0, t1))

    def answer(self, k: int, result, wall_s: float, phase: str) -> None:
        self.answers.append(Answer(k, result, wall_s, phase))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def drive(entry, program, inputs, mix: dict, device, *, seconds: float,
          profile: Optional[Callable] = None, grace_s: float = 60.0):
    """Set up ``entry.Entry``, then run the window; ``profile(fn)`` runs
    ``fn`` under the profiler after it.  Returns ``(loop, setup_end,
    profiled)``, with the program's state released."""
    loop = Loop()
    traffic = entry.Entry(program, inputs, mix, device, loop)
    sync(device)
    t0 = time.perf_counter()
    # the first answer at or after `seconds`; without one, `grace_s` later
    traffic.run(lambda now, answered: now - t0 >= (
        seconds if answered else seconds + grace_s), WINDOW)
    loop.window_s = time.perf_counter() - t0
    profiled = None
    if profile is not None:
        before = traffic.counters()

        def stretch():
            t1 = time.perf_counter()
            traffic.run(lambda now, answered: now - t1 >= (
                mix["profile_seconds"] if answered else grace_s), TRACED)

        profiled = profile(stretch)
        loop.counters = {k: v - before.get(k, 0)
                         for k, v in traffic.counters().items()}
    traffic.drain(grace_s)
    traffic.close()
    return loop, t0, profiled
