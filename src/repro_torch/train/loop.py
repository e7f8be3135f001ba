"""The train step and the host training loop (the torch port of
:mod:`repro.train.loop`).

``make_train_step`` returns one function

    train_step(params, opt_state, batch, step) -> (params, opt_state,
                                                   metrics)

with microbatch gradient accumulation (the reference's strided split:
microbatch i takes rows i, i + k, i + 2k, …), the loss and the gradients
summed in fp32 and divided by k, and AdamW with bf16 moments.  ``params``
is the model (:func:`~repro_torch.models.api.model_class`'s module); the
step turns its gradients on for the backward (the blocks are checkpointed
if ``cfg.remat``) and off again, and updates it in place — the
reference's donated buffers.

``Trainer`` is the host loop: deterministic data cursor, periodic atomic
checkpoints, a straggler deadline (:mod:`repro_torch.train.fault`), and a
resume that continues bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.core.gn import param_dict
from repro_torch.device import resolve_device
from repro_torch.models.api import loss_fn
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import StepWatchdog
from repro_torch.train.optim import (AdamWConfig, adamw_update,
                                     cosine_schedule)

__all__ = ["make_train_step", "loss_and_grads", "Trainer", "TrainerConfig"]


def _value_and_grad(params, cfg: ModelConfig, batch):
    """Loss and ``{name: grad}`` of the model on ``batch``."""
    names, plist = zip(*params.named_parameters())
    params.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, plist)
    finally:
        params.requires_grad_(False)
    return loss.detach(), dict(zip(names, grads))


def loss_and_grads(params, cfg: ModelConfig, batch, microbatches: int = 1):
    """The mean loss and ``{name: grad}`` over ``batch``, in
    ``microbatches`` strided slices (microbatch i takes rows i, i + k, …,
    as the reference's ``reshape(B//k, k, …).swapaxes(0, 1)``), each
    slice's loss and gradients summed in fp32 and divided by k."""
    if microbatches == 1:
        return _value_and_grad(params, cfg, batch)
    k = microbatches
    tot_l = torch.zeros((), dtype=torch.float32,
                        device=batch["tokens"].device)
    tot_g = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in param_dict(params).items()}
    for i in range(k):
        # strided split keeps every microbatch spanning all data shards
        # (the reference's launch/dryrun.py)
        micro = {key: x.reshape(x.shape[0] // k, k, *x.shape[1:])[:, i]
                 for key, x in batch.items()}
        l, g = _value_and_grad(params, cfg, micro)
        tot_l = tot_l + l
        for n, gi in g.items():
            tot_g[n].add_(gi)
        del g
    return tot_l / k, {n: g.div_(k) for n, g in tot_g.items()}


def make_train_step(cfg: ModelConfig, mesh=None, *,
                    opt: AdamWConfig = AdamWConfig(),
                    schedule: Optional[Callable] = None,
                    microbatches: int = 1, device=None):
    """Build the train step on ``device`` (default ``cuda``):
    :func:`loss_and_grads`, then AdamW at ``schedule(step)``.

    ``mesh=`` (the reference's sharded step) waits for the port's sharding
    module and raises.  The reference's ``donate`` has no counterpart: the
    step updates the parameters and moments in place.
    """
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=): the sharded train step waits for "
            "distributed/sharding.py (ROADMAP A.9.7)")
    resolve_device(device)
    schedule = schedule or cosine_schedule(opt.lr, 100, 10_000)

    def step_fn(params, opt_state, batch, step):
        loss, grads = loss_and_grads(params, cfg, batch, microbatches)
        lr = schedule(step)
        params, opt_state = adamw_update(grads, opt_state, params, opt, lr)
        return params, opt_state, {"loss": loss, "lr": lr}

    return step_fn


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    step_deadline_s: Optional[float] = None     # straggler budget


class Trainer:
    """Host loop: data cursor, checkpoints, watchdog, resume.

    ``generator`` is the run's own generator (the reference's ``key``),
    saved and restored with the parameters; nothing in the AdamW step
    draws from it.
    """

    def __init__(self, cfg: ModelConfig, data, train_step, params,
                 opt_state, tcfg: TrainerConfig,
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.data = data
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.tcfg = tcfg
        self.generator = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.step = 0
        self.metrics_log = []
        self.watchdog = StepWatchdog(tcfg.step_deadline_s)

    # ---- fault tolerance ------------------------------------------------
    def _tree(self):
        return {"params": param_dict(self.params), "opt": self.opt_state,
                "gen": self.generator.get_state()}

    def save(self):
        meta = {"cursor": self.data.cursor(self.step),
                "arch": self.cfg.name}
        ckpt.save(self.tcfg.ckpt_dir, self.step, self._tree(), meta)

    @torch.no_grad()
    def try_resume(self) -> bool:
        """Load the latest checkpoint into this trainer's tensors (in
        place); False if there is none."""
        last = ckpt.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return False
        template = self._tree()
        tree, meta = ckpt.restore(self.tcfg.ckpt_dir, template, step=last)
        for n, t in param_dict(self.params).items():
            t.copy_(tree["params"][n])
        for n in self.opt_state.m:
            self.opt_state.m[n].copy_(tree["opt"].m[n])
            self.opt_state.v[n].copy_(tree["opt"].v[n])
        self.opt_state = self.opt_state._replace(step=tree["opt"].step)
        self.generator.set_state(tree["gen"])
        self.step = meta["cursor"]["step"]
        return True

    # ---- the loop ---------------------------------------------------------
    def run(self, steps: Optional[int] = None):
        end = self.step + (steps if steps is not None
                           else self.tcfg.total_steps)
        while self.step < end:
            batch = self.data.batch_at(self.step)
            with self.watchdog.guard(self.step):
                t0 = time.monotonic()
                self.params, self.opt_state, m = self.train_step(
                    self.params, self.opt_state, batch, self.step)
                m = {k: float(v) for k, v in m.items()}
                m["step_time_s"] = time.monotonic() - t0
            self.metrics_log.append({"step": self.step, **m})
            if self.tcfg.log_every and self.step % self.tcfg.log_every == 0:
                print(f"step {self.step:5d}  loss {m['loss']:.4f}  "
                      f"({m['step_time_s']*1e3:.0f} ms)")
            self.step += 1
            if self.tcfg.ckpt_every and self.step % self.tcfg.ckpt_every == 0:
                self.save()
        return self.metrics_log
