"""Fault tolerance — straggler watchdog and retries (the torch port of
:mod:`repro.train.fault`).

* :class:`StepWatchdog` — a per-step wall-clock deadline.  A breach is
  recorded; after ``max_breaches`` consecutive slow steps it raises
  :class:`StragglerError`, so the caller can restart from the last
  checkpoint.
* :func:`with_retries` — runs a step with bounded retries for transient
  faults.
* :func:`elastic_restore` — restores a checkpoint onto a DIFFERENT mesh:
  checkpoints hold whole tensors (:mod:`repro_torch.train.checkpoint`),
  so only the layout changes.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Optional

from torch import nn

from repro_torch.distributed.sharding import named_shardings, param_specs
from repro_torch.train import checkpoint as ckpt

__all__ = ["StragglerError", "StepWatchdog", "with_retries",
           "elastic_restore"]


class StragglerError(RuntimeError):
    """Raised after too many consecutive deadline breaches."""


class StepWatchdog:
    def __init__(self, deadline_s: Optional[float],
                 max_breaches: int = 3):
        self.deadline_s = deadline_s
        self.max_breaches = max_breaches
        self.breaches = 0
        self.consecutive = 0
        self.slow_steps = []

    @contextlib.contextmanager
    def guard(self, step: int):
        t0 = time.monotonic()
        yield
        dt = time.monotonic() - t0
        if self.deadline_s is not None and dt > self.deadline_s:
            self.breaches += 1
            self.consecutive += 1
            self.slow_steps.append((step, dt))
            if self.consecutive >= self.max_breaches:
                raise StragglerError(
                    f"{self.consecutive} consecutive steps over the "
                    f"{self.deadline_s}s deadline (last: {dt:.2f}s at "
                    f"step {step})")
        else:
            self.consecutive = 0


def with_retries(fn: Callable, *args, retries: int = 2,
                 retry_on=(RuntimeError,), on_retry: Callable = None,
                 **kwargs):
    """Run ``fn`` with bounded retries on transient faults."""
    last = None
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:          # noqa: PERF203
            last = e
            if on_retry is not None:
                on_retry(attempt, e)
    raise last


def elastic_restore(root: str, template: Any, new_mesh, *,
                    step: Optional[int] = None):
    """Restore parameters onto ``new_mesh``: ``template`` is a module or a
    ``{name: tensor}`` mapping, each leaf laid out by
    :func:`~repro_torch.distributed.sharding.param_specs` on the new mesh
    (the mesh that saved does not matter: leaves are stored whole).
    Returns ``({name: DTensor}, metadata)``."""
    if isinstance(template, nn.Module):
        template = {n: p.detach() for n, p in template.named_parameters()}
    shardings = named_shardings(param_specs(template, new_mesh), new_mesh)
    return ckpt.restore(root, template, step=step, shardings=shardings)
