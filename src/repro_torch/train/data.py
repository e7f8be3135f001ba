"""Deterministic synthetic LM data with an explicit cursor (the torch port
of :mod:`repro.train.data`).

The pipeline is a pure function of ``(seed, step)`` — ``batch_at(step)``
draws from a ``torch.Generator`` seeded by the pair — so the cursor in a
checkpoint is the step integer and a restart is bitwise reproducible.  The
bits differ from the reference's ``jax.random`` draws; the structure is
the same:

* ``markov`` — an order-1 walk over the vocab: each token is the previous
  one plus a step uniform in ``[−band, band]``, mod ``vocab``;
* ``uniform`` — i.i.d. tokens.

Labels are next-token shifted; the final position predicts token 0.
Tokens and labels are int64 (torch's index dtype).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["DataConfig", "SyntheticLM", "step_generator"]


def step_generator(seed: int, step: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded by the pair ``(seed, step)`` (mixed
    by numpy's ``SeedSequence``): a step's draws are a pure function of
    the pair."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "markov"        # "markov" | "uniform"
    band: int = 16                # markov: next token within ±band of prev


class SyntheticLM:
    """Stateless-per-step synthetic token stream; batches are drawn on the
    host and land on ``device`` (default ``cuda``)."""

    def __init__(self, cfg: DataConfig, *, device=None):
        if cfg.source not in ("markov", "uniform"):
            raise ValueError(f"unknown source {cfg.source!r}")
        self.cfg = cfg
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        gen = step_generator(cfg.seed, step)
        b, s = cfg.global_batch, cfg.seq_len
        if cfg.source == "uniform":
            toks = torch.randint(0, cfg.vocab, (b, s), generator=gen)
        else:
            start = torch.randint(0, cfg.vocab, (b, 1), generator=gen)
            steps = torch.randint(-cfg.band, cfg.band + 1, (b, s - 1),
                                  generator=gen)
            # the walk (tok + d) mod vocab, step by step, is the running
            # sum mod vocab
            toks = torch.remainder(
                torch.cat([start, steps], dim=1).cumsum(1), cfg.vocab)
        labels = torch.cat([toks[:, 1:], torch.zeros((b, 1),
                                                     dtype=toks.dtype)], 1)
        return {"tokens": toks.to(self.device),
                "labels": labels.to(self.device)}

    def cursor(self, step: int) -> Dict[str, object]:
        """Checkpointable loader state — the step is the whole cursor."""
        return {"seed": self.cfg.seed, "step": step,
                "source": self.cfg.source}
