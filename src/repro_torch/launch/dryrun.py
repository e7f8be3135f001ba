"""Multi-pod dry run — proves the distribution config is coherent (the
torch port of :mod:`repro.launch.dryrun`).

For every (architecture × input shape) cell, on the single-pod (16×16)
and multi-pod (2×16×16) production meshes, one process stands in for
rank 0 of a fake process group of world size 256 or 512
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once and move nothing).  The parameters, optimizer state and inputs are
``meta`` tensors (:func:`repro_torch.configs.input_specs`) laid out as
DTensors by the sharding rules, so nothing is allocated and no card is
used.  The cell's step runs once, eagerly, under
:func:`repro_torch.roofline.counting`, which records what rank 0 does:

* per-rank argument bytes — exact, the sum of the local shards' sizes;
* peak temporaries — the most bytes the storages the step creates hold at
  once (``CostWalk.peak_bytes``), and ``fits_hbm`` against
  :data:`repro_torch.roofline.H100`;
* flops and bytes (:func:`~repro_torch.roofline.count_torch`'s rules)
  and the collectives DTensor issues, by kind and wire bytes
  (:mod:`repro_torch.roofline.collectives`);
* the three roofline terms.

The train step traces ONE microbatch (forward, backward and the
gradients' redistribution) and multiplies its counts by the number of
microbatches, then adds the AdamW update once: the loop multiplicity
``walk_hlo`` applies to the reference's ``lax.scan`` body.  That number is
:data:`TRAIN_MICROBATCHES` when it divides the per-shard batch, and the
per-shard batch otherwise (the 2×16×16 mesh holds 8 sequences a shard,
where the reference pads 16 over 32 shards): one sequence a device a
microbatch either way; the record says which.

Artifacts land as JSON under ``experiments/dryrun_torch/<mesh>/``.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh single
    python -m repro_torch.launch.dryrun --all --mesh multi

The reference's hillclimb switches, read once at import from
``REPRO_DRYRUN_OPTS`` (names separated by commas; unknown names are
ignored) into :data:`OPTS`::

    REPRO_DRYRUN_OPTS=bf16_gather python -m repro_torch.launch.dryrun \
        --arch gemma3-1b --shape train_4k

* ``bf16_gather`` — the train step casts every fp32 parameter that is a
  matrix by the reference's leaf shapes (:func:`~repro_torch.train.optim
  .matrix_leaf`: a stacked layer's norm gain is one) to bf16 ONCE, before
  the microbatches (:func:`bf16_view`).  The cast is local to each shard
  (a DTensor keeps its placements, no collective), so a gather an op
  needs moves bf16.  The gradients are taken with respect to the bf16
  view and summed into the fp32 accumulators
  (:func:`~repro_torch.train.loop.accumulate`); AdamW updates the fp32
  masters.  The cast is counted once, outside the microbatch
  multiplicity.  (``dense`` already casts a sharded weight locally before
  its matmul gathers it, so the switch moves fewer wire bytes here than
  under XLA: the gradients' reductions.)
* ``ssd_chunk64`` / ``ssd_chunk128`` — the SSD chunk length of an SSM or
  hybrid config (default 256; ``ssd_chunk64`` wins when both are set):
  the chunk-quadratic intra term scales about linearly with the chunk.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import SHAPES, applicable, cells, get_config, \
    input_specs
from repro_torch.distributed.hints import DATA, hint, sharding_hints
from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                              data_axes, distribute,
                                              distribute_tree,
                                              named_shardings)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import decode_step, forward_logits, model_class
from repro_torch.roofline import (H100, counting, model_flops_decode,
                                  model_flops_train, roofline_terms)
from repro_torch.roofline.torch_cost import CostWalk
from repro_torch.train.loop import _mesh_adamw, accumulate
from repro_torch.train.optim import AdamWConfig, adamw_init, matrix_leaf

__all__ = ["build_cell", "run_cell", "main", "ART_DIR", "OPTS",
           "TRAIN_MICROBATCHES", "start_fake_group", "bf16_view"]

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

#: grad-accumulation microbatches for the train shape (memory feasibility:
#: 1 sequence / device / microbatch at global_batch=256 on a 16×16 mesh).
TRAIN_MICROBATCHES = 16

#: world size of each production mesh
WORLD = {"single": 256, "multi": 512}

#: the hillclimb switches (see the module docstring)
OPTS = frozenset(o for o in os.environ.get(
    "REPRO_DRYRUN_OPTS", "").split(",") if o)


def _with_opts(cfg):
    """``cfg`` with the SSD chunk :data:`OPTS` asks for (SSM configs)."""
    if cfg.ssm is None:
        return cfg
    if "ssd_chunk64" in OPTS:
        chunk = 64
    elif "ssd_chunk128" in OPTS:
        chunk = 128
    else:
        return cfg
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk=chunk))


def bf16_view(params) -> Dict[str, torch.Tensor]:
    """``bf16_gather``'s view: ``{name: p in bf16}`` for every fp32
    parameter that is a matrix by the reference's leaf shapes, cast while
    it is sharded (a DTensor's cast keeps its placements and is local),
    detached: the leaves the gradients are taken with respect to."""
    with torch.no_grad():
        return {n: p.detach().to(torch.bfloat16)
                for n, p in params.named_parameters()
                if p.dtype == torch.float32 and matrix_leaf(n, p)}


def start_fake_group(world: int) -> None:
    """Rank 0 of a fake process group of ``world`` ranks (nothing moves)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(tree) -> int:
    """Bytes of the local shards (rank 0's) of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor
    out = 0
    for t in _leaves(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        out += loc.numel() * loc.element_size()
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def _shard_batch(batch: Dict[str, torch.Tensor], mesh):
    sh = named_shardings(batch_specs(batch, mesh), mesh)
    return distribute_tree(batch, sh)


def _micro_count(per_shard: int) -> int:
    return TRAIN_MICROBATCHES if per_shard % TRAIN_MICROBATCHES == 0 \
        else per_shard


def build_cell(arch, shape_name: str, mesh):
    """``(fn, args, info)``: ``fn(*args)`` runs the cell's step on rank 0's
    shards and returns the :class:`CostWalk` to record (counted inside,
    with the train step's microbatch multiplicity applied); ``args`` are
    the step's arguments (their local bytes are the argument bytes)."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = _with_opts(get_config(arch))
    shape = SHAPES[shape_name]
    specs = input_specs(cfg, shape_name)
    params = distribute(model_class(cfg)(cfg, device="meta"), mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    if shape.kind == "train":
        opt = AdamWConfig()
        opt_state = adamw_init(params, opt)
        batch = _shard_batch(specs, mesh)
        dsize = math.prod(sizes[a] for a in data_axes(mesh))
        per_shard = shape.global_batch // dsize
        k = _micro_count(per_shard)
        micro = _shard_batch(
            {n: torch.empty((shape.global_batch // k, *t.shape[1:]),
                            dtype=t.dtype, device="meta")
             for n, t in specs.items()}, mesh)

        def train_step(params, opt_state, batch):
            with counting() as walk, sharding_hints(mesh), \
                    implicit_replication():
                acc = {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in params.named_parameters()}
                # once a step, before the microbatches
                view = bf16_view(params) if "bf16_gather" in OPTS else None
                before = copy.deepcopy(walk)
                accumulate(params, cfg, micro, acc, view)
                one = _minus(walk, before)
                del view
                _mesh_adamw({n: g.div_(k) for n, g in acc.items()},
                            opt_state, params, opt,
                            torch.tensor(3e-4, dtype=torch.float32))
            return _plus(walk, one, k - 1)

        return train_step, (params, opt_state, batch), dict(microbatches=k)

    if shape.kind == "prefill":
        batch = _shard_batch(specs, mesh)

        @torch.no_grad()
        def prefill_step(params, batch):
            # serving prefill: only the last position's logits materialize
            with counting() as walk, sharding_hints(mesh), \
                    implicit_replication():
                forward_logits(params, cfg, batch, last_only=True)[:, 0]
            return walk

        return prefill_step, (params, batch), {}

    # decode
    c_sh = named_shardings(cache_specs(specs["cache"], mesh,
                                       batch=shape.global_batch), mesh)
    cache = distribute_tree(specs["cache"], c_sh)
    tok_spec = ("data",) if shape.global_batch % sizes.get("data", 1) == 0 \
        else (None,)
    token = distribute_tree(specs["token"],
                            named_shardings(tok_spec, mesh))

    @torch.no_grad()
    def serve_step(params, cache, token, pos):
        with counting() as walk, sharding_hints(mesh), \
                implicit_replication():
            logits, _ = decode_step(params, cfg, cache, token, pos)
            # the vocab gathered for the argmax (DTensor's argmax over a
            # sharded dim gathers too, but not under the fake group)
            torch.argmax(hint(logits, DATA, None), dim=-1).to(torch.int32)
        return walk

    return serve_step, (params, cache, token, specs["pos"]), {}


def _minus(a: CostWalk, b: CostWalk) -> CostWalk:
    return CostWalk(
        flops=a.flops - b.flops,
        transcendentals=a.transcendentals - b.transcendentals,
        hbm_bytes=a.hbm_bytes - b.hbm_bytes,
        wire_bytes=a.wire_bytes - b.wire_bytes,
        collective_count=a.collective_count - b.collective_count,
        wire_by_kind={k: v - b.wire_by_kind.get(k, 0)
                      for k, v in a.wire_by_kind.items()})


def _plus(a: CostWalk, b: CostWalk, mult: float) -> CostWalk:
    """``a`` plus ``mult`` times ``b`` (``a``'s peak kept)."""
    kinds = set(a.wire_by_kind) | set(b.wire_by_kind)
    return CostWalk(
        flops=a.flops + mult * b.flops,
        transcendentals=a.transcendentals + mult * b.transcendentals,
        hbm_bytes=a.hbm_bytes + mult * b.hbm_bytes,
        wire_bytes=a.wire_bytes + mult * b.wire_bytes,
        collective_count=a.collective_count + mult * b.collective_count,
        wire_by_kind={k: a.wire_by_kind.get(k, 0)
                      + mult * b.wire_by_kind.get(k, 0) for k in kinds},
        peak_bytes=a.peak_bytes)


def run_cell(arch, shape_name: str, mesh_kind: str,
             save: bool = True, art_dir: Optional[str] = None) -> dict:
    """One cell's record (``arch`` an id or a ``ModelConfig``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    rec = {"arch": arch if isinstance(arch, str) else cfg.name,
           "shape": shape_name, "mesh": mesh_kind}
    if not ok:
        rec.update(status="SKIP", reason=why)
        return rec

    start_fake_group(WORLD[mesh_kind])
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_type="cpu")
    chips = mesh.size()
    t0 = time.time()
    fn, args, info = build_cell(arch, shape_name, mesh)
    t_build = time.time() - t0
    arg_bytes = _local_bytes(args)
    t0 = time.time()
    walk = fn(*args)
    t_trace = time.time() - t0

    cost = {"flops": walk.flops, "bytes accessed": walk.hbm_bytes,
            "transcendentals": walk.transcendentals}
    coll = {"total_wire_bytes": walk.wire_bytes,
            "n_ops": walk.collective_count, "by_kind": walk.wire_by_kind}
    mem = {"argument_bytes": arg_bytes, "temp_bytes": walk.peak_bytes,
           "total_bytes": arg_bytes + walk.peak_bytes}

    n_active = cfg.active_param_count()
    if shape.kind == "train":
        mf = model_flops_train(n_active, shape.global_batch * shape.seq_len)
    elif shape.kind == "prefill":
        mf = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:
        mf = model_flops_decode(n_active, shape.global_batch)
    terms = roofline_terms(cost, coll["total_wire_bytes"], chips=chips,
                           model_flops=mf)
    rec.update(
        status="OK",
        kind=shape.kind,
        chips=chips,
        build_s=round(t_build, 2),
        trace_s=round(t_trace, 2),
        cost=cost,
        memory=mem,
        fits_hbm=mem["total_bytes"] <= H100.hbm_bytes,
        collectives=coll,
        roofline=terms.as_dict(),
        counted="rank 0 of a fake process group: counted, not measured",
    )
    if shape.kind == "train":
        k = info["microbatches"]
        rec.update(microbatches=k, multiplicity=(
            f"one microbatch traced and counted x{k} (walk_hlo's loop "
            "multiplicity), the AdamW update once; the peak is one "
            "microbatch's with the fp32 accumulators live"))
    if save:
        d = os.path.join(art_dir or ART_DIR, mesh_kind)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{rec['arch']}__{shape_name}.json"),
                  "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="artifact directory (default experiments/"
                         "dryrun_torch)")
    ap.add_argument("--subprocess", action="store_true",
                    help="run each cell in a fresh process (isolation)")
    args = ap.parse_args(argv)

    if args.all:
        results = []
        for arch, shape_name, ok, why in cells():
            if args.subprocess and ok:
                import subprocess
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_name,
                       "--mesh", args.mesh]
                if args.out:
                    cmd += ["--out", args.out]
                r = subprocess.run(cmd, capture_output=True, text=True)
                status = "OK" if r.returncode == 0 else "FAIL"
                print(f"{arch:24s} {shape_name:12s} {status}")
                if r.returncode != 0:
                    print(r.stdout[-2000:], r.stderr[-2000:])
                results.append({"status": status})
                continue
            try:
                rec = run_cell(arch, shape_name, args.mesh,
                               art_dir=args.out)
            except Exception as e:                        # noqa: BLE001
                rec = {"arch": arch, "shape": shape_name,
                       "mesh": args.mesh, "status": "FAIL",
                       "error": f"{type(e).__name__}: {e}"}
                traceback.print_exc()
            results.append(rec)
            t = rec.get("roofline", {})
            print(f"{arch:24s} {shape_name:12s} {rec['status']:4s} "
                  f"trace={rec.get('trace_s', '-')}s "
                  f"dom={t.get('dominant', '-')}", flush=True)
        n_fail = sum(1 for r in results if r["status"] == "FAIL")
        print(f"\n{len(results)} cells: "
              f"{sum(1 for r in results if r['status'] == 'OK')} OK, "
              f"{sum(1 for r in results if r['status'] == 'SKIP')} SKIP, "
              f"{n_fail} FAIL")
        sys.exit(1 if n_fail else 0)

    rec = run_cell(args.arch, args.shape, args.mesh, art_dir=args.out)
    print(json.dumps({k: v for k, v in rec.items() if k != "collectives"},
                     indent=1))
    if rec["status"] == "FAIL":
        sys.exit(1)


if __name__ == "__main__":
    main()
