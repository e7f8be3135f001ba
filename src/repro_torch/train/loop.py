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

With a mesh (a ``DeviceMesh``, :mod:`repro_torch.launch.mesh`),
``make_train_step(cfg, mesh)`` returns ``jit_for(batch_shape)``, as the
reference does, and ``jit_for`` returns the sharded step.  SPMD: every
rank runs it on its own shards.

* The parameters are DTensors by
  :func:`~repro_torch.distributed.sharding.param_specs`
  (:func:`~repro_torch.distributed.sharding.distribute`); the AdamW
  moments share their placements (:func:`~repro_torch.train.optim
  .adamw_init` of the distributed module) and ``step`` is replicated.
* The batch (whole tensors, the same on every rank, or DTensors) is
  sharded over :func:`~repro_torch.distributed.sharding.data_axes` by
  :func:`~repro_torch.distributed.sharding.batch_specs`.
* The forward and backward run under ``implicit_replication()`` (the
  tensors the model builds itself — positions, masks, RoPE tables — are
  plain and count as replicated) with the model's hints active
  (:mod:`repro_torch.distributed.hints`).  The loss is
  :func:`~repro_torch.models.api.loss_fn`, which on DTensors takes each
  rank's rows of the logits with the vocab dim replicated.
* Each gradient comes back ``Partial`` and is redistributed to its
  parameter's placements (a reduce-scatter or an all-reduce).  The global
  norm for clipping sums each leaf's squares as a DTensor (reduced over
  the mesh dims that shard it) in the unsharded step's order; AdamW then
  updates each local shard in place (:func:`~repro_torch.train.optim
  .adamw_update` on the local tensors).
* The microbatch strided split runs on the local batch shard: it is the
  global strided split when ``microbatches`` divides the per-shard batch,
  and ``jit_for`` raises ``ValueError`` otherwise.

At world size 1 the sharded step is the unsharded one bit for bit.  No
parameter is gathered whole for the step; DTensor's own op rules move
what each op needs.

``Trainer`` is the host loop: deterministic data cursor, periodic atomic
checkpoints, a straggler deadline (:mod:`repro_torch.train.fault`), and a
resume that continues bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.gn import param_dict
from repro_torch.device import resolve_device
from repro_torch.distributed.hints import sharding_hints
from repro_torch.distributed.sharding import (batch_specs, data_axes,
                                              named_shardings)
from repro_torch.models.api import loss_fn
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import StepWatchdog
from repro_torch.train.optim import (AdamWConfig, AdamWState, adamw_update,
                                     cosine_schedule)

__all__ = ["make_train_step", "loss_and_grads", "accumulate", "Trainer",
           "TrainerConfig"]


@contextlib.contextmanager
def _viewing(module: torch.nn.Module, view: Optional[Dict]):
    """``module`` with each parameter named in ``view`` replaced by
    ``view[name]`` (in every module that holds it, so a tied weight is
    replaced once), restored on exit.  The replacements stay in place
    through a backward, so a checkpointed block recomputes with them."""
    if not view:
        yield
        return
    by_id = {id(p): view[n] for n, p in module.named_parameters()
             if n in view}
    swapped = []
    for m in module.modules():
        for k, p in m._parameters.items():
            if p is not None and id(p) in by_id:
                swapped.append((m, k, p))
    try:
        for m, k, p in swapped:
            m._parameters[k] = by_id[id(p)]
        yield
    finally:
        for m, k, p in swapped:
            m._parameters[k] = p


def _value_and_grad(params, cfg: ModelConfig, batch,
                    view: Optional[Dict] = None):
    """Loss and ``{name: grad}`` of the model on ``batch``.  On DTensor
    parameters (the sharded step) the loss is a plain replicated scalar
    and each gradient is laid out as its parameter.  ``view`` (``{name:
    tensor}``, detached leaves of the parameters' shapes) stands in for
    the parameters it names, in the forward and the backward, and the
    gradients are taken with respect to it (the dry run's ``bf16_gather``
    view)."""
    from torch.distributed.tensor import DTensor
    with _viewing(params, view):
        names, plist = zip(*params.named_parameters())
        sharded = isinstance(plist[0], DTensor)
        params.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = loss_fn(params, cfg, batch)
                if sharded:
                    loss = loss.full_tensor()
                grads = torch.autograd.grad(loss, plist)
        finally:
            params.requires_grad_(False)
    if sharded:
        grads = [g.redistribute(p.device_mesh, p.placements)
                 for p, g in zip(plist, grads)]
    return loss.detach(), dict(zip(names, grads))


def _micro(x, i: int, k: int):
    """Microbatch ``i`` of ``k``: rows i, i + k, … (the reference's
    ``reshape(B//k, k, …).swapaxes(0, 1)``).  Of a batch DTensor, the rows
    of its local shard: the global strided split when k divides the
    per-shard batch."""
    from torch.distributed.tensor import DTensor
    loc = x.to_local() if isinstance(x, DTensor) else x
    loc = loc.reshape(loc.shape[0] // k, k, *loc.shape[1:])[:, i]
    if not isinstance(x, DTensor):
        return loc
    return DTensor.from_local(loc, x.device_mesh, x.placements,
                              run_check=False)


def loss_and_grads(params, cfg: ModelConfig, batch, microbatches: int = 1):
    """The mean loss and ``{name: grad}`` over ``batch``, in
    ``microbatches`` strided slices (:func:`_micro`), each slice's loss
    and gradients summed in fp32 and divided by k.  On DTensors the sums
    are laid out as the parameters."""
    if microbatches == 1:
        return _value_and_grad(params, cfg, batch)
    k = microbatches
    tot_l = torch.zeros((), dtype=torch.float32,
                        device=batch["tokens"].device)
    tot_g = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in param_dict(params).items()}
    for i in range(k):
        # strided split keeps every microbatch spanning all data shards
        # (the reference's launch/dryrun.py)
        tot_l = tot_l + accumulate(params, cfg, {key: _micro(x, i, k)
                                                 for key, x in batch.items()},
                                   tot_g)
    return tot_l / k, {n: g.div_(k) for n, g in tot_g.items()}


def accumulate(params, cfg: ModelConfig, micro, acc: Dict[str, torch.Tensor],
               view: Optional[Dict[str, torch.Tensor]] = None
               ) -> torch.Tensor:
    """One microbatch: its loss, and each gradient (with respect to
    ``view``'s tensor where it names the parameter, see
    :func:`_value_and_grad`) added into its fp32 accumulator ``acc[name]``
    in place."""
    loss, grads = _value_and_grad(params, cfg, micro, view)
    for n, g in grads.items():
        acc[n].add_(g)
    return loss


def make_train_step(cfg: ModelConfig, mesh=None, *,
                    opt: AdamWConfig = AdamWConfig(),
                    schedule: Optional[Callable] = None,
                    microbatches: int = 1, params_shape: Any = None,
                    device=None):
    """Build the train step on ``device`` (default ``cuda``):
    :func:`loss_and_grads`, then AdamW at ``schedule(step)``.

    With ``mesh``, return ``jit_for(batch_shape)`` (``{key: tensor or
    shape}``), which returns the sharded step on the mesh's device (see
    the module docstring).  ``params_shape`` is taken for the reference's
    signature; the step reads each parameter's placements from the
    (distributed) module it is given.  The reference's ``donate`` has no
    counterpart: the step updates the parameters and moments in place.
    """
    schedule = schedule or cosine_schedule(opt.lr, 100, 10_000)
    if mesh is not None:
        return _mesh_jit_for(cfg, mesh, opt, schedule, microbatches)
    resolve_device(device)

    def step_fn(params, opt_state, batch, step):
        loss, grads = loss_and_grads(params, cfg, batch, microbatches)
        lr = schedule(step)
        params, opt_state = adamw_update(grads, opt_state, params, opt, lr)
        return params, opt_state, {"loss": loss, "lr": lr}

    return step_fn


# ------------------------------------------------------------- the mesh
def _shard(x, sharding):
    """A batch leaf as a DTensor laid out by ``sharding``: a whole tensor
    (the same on every rank) keeps each rank's shard, no communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh, pl = sharding
    if isinstance(x, DTensor):
        return x.redistribute(mesh, pl)
    return distribute_tensor(x.to(mesh.device_type), mesh, pl,
                             src_data_rank=None)


@torch.no_grad()
def _mesh_adamw(grads: Dict, state: AdamWState, params, opt: AdamWConfig,
                lr):
    """AdamW on DTensors: the global-norm clip over the whole gradient
    (each leaf's sum of squares reduced over the mesh, summed in the
    unsharded order), then :func:`adamw_update` on each rank's local
    shards, in place."""
    local = {n: g.to_local() for n, g in grads.items()}
    if opt.grad_clip:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float())).full_tensor()
                            for g in grads.values()))
        scale = torch.clamp(opt.grad_clip / torch.clamp(gn, min=1e-9),
                            max=1.0)
        local = {n: (g.float() * scale).to(g.dtype)
                 for n, g in local.items()}
    ps = {n: p.to_local() for n, p in param_dict(params).items()}
    loc_state = AdamWState(step=state.step,
                           m={n: t.to_local() for n, t in state.m.items()},
                           v={n: t.to_local() for n, t in state.v.items()})
    _, new = adamw_update(local, loc_state, ps,
                          dataclasses.replace(opt, grad_clip=0.0), lr)
    return params, AdamWState(step=new.step, m=state.m, v=state.v)


def _mesh_jit_for(cfg: ModelConfig, mesh, opt: AdamWConfig,
                       schedule: Callable, microbatches: int):
    def jit_for(batch_shape):
        b_sh = named_shardings(batch_specs(batch_shape, mesh), mesh)
        b = tuple(getattr(batch_shape["tokens"], "shape",
                          batch_shape["tokens"]))[0]
        split = math.prod(mesh.size(i) for i, p in
                          enumerate(b_sh["tokens"].placements)
                          if p.is_shard(0))
        if (b // split) % microbatches:
            raise ValueError(
                f"{microbatches} microbatches do not divide the per-shard "
                f"batch {b // split} (batch {b} over {data_axes(mesh)})")
        from torch.distributed.tensor.experimental import \
            implicit_replication

        def step_fn(params, opt_state, batch, step):
            batch = {key: _shard(x, b_sh[key]) for key, x in batch.items()}
            with sharding_hints(mesh), implicit_replication():
                loss, grads = loss_and_grads(params, cfg, batch,
                                             microbatches)
                lr = schedule(step)
                params, opt_state = _mesh_adamw(grads, opt_state, params,
                                                opt, lr)
            return params, opt_state, {"loss": loss, "lr": lr}

        return step_fn

    return jit_for


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
