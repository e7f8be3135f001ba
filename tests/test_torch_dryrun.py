"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: one
subprocess, a fake process group of world size 256 and then 512, meta
tensors, no card.

gemma3-1b at 2 of its 26 layers (full width), one train, one prefill and
one decode cell on the 16×16 and 2×16×16 production meshes:

* status OK; the argument bytes equal a hand sum over the specs (each
  sharded dim divided by its axes' sizes, fp32 parameters, bf16 AdamW
  moments, int64 tokens, the bf16 cache);
* collectives recorded, ``fits_hbm`` set, the roofline terms present;
* the train cell's microbatches: 16 on 16×16 (16 sequences a data shard),
  8 on 2×16×16 (8 a shard);
* a ``long_500k`` cell of a full-attention model is SKIP with the
  reference's reason.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import SHAPES as REF_SHAPES, applicable as ref_applicable
from repro.configs import get_config as ref_get_config

from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.distributed import sharding as S
from repro_torch.models.api import model_class

SRC = str(Path(__file__).resolve().parents[1] / "src")
#: seconds the subprocess may take before the test fails
TIMEOUT = 300
LAYERS = 2
CELLS = ("train_4k", "prefill_32k", "decode_32k")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

_RUN = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
cfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=%d)
out = {}
for mesh in ("single", "multi"):
    for shape in %r:
        out[f"{mesh}/{shape}"] = dryrun.run_cell(cfg, shape, mesh, save=False)
out["skip"] = dryrun.run_cell("qwen2.5-32b", "long_500k", "single",
                              save=False)
print(json.dumps(out))
""" % (LAYERS, CELLS)


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", _RUN], env=env,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _local_bytes(shape, spec, mesh, itemsize):
    n = 1
    for dim, entry in zip(shape, spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= dim // math.prod(mesh.shape[a] for a in axes)
    return n * itemsize


def _hand_sum(shape_name, mesh):
    cfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=LAYERS)
    shape = SHAPES[shape_name]
    module = model_class(cfg)(cfg, device="meta")
    pspecs = S.param_specs(module, mesh)
    params = sum(_local_bytes(p.shape, pspecs[n], mesh, 4)
                 for n, p in module.named_parameters())
    specs = input_specs(cfg, shape_name)
    if shape.kind == "train":
        moments = 2 * sum(_local_bytes(p.shape, pspecs[n], mesh, 2)
                          for n, p in module.named_parameters())
        bspecs = S.batch_specs(specs, mesh)
        batch = sum(_local_bytes(t.shape, bspecs[k], mesh, t.element_size())
                    for k, t in specs.items())
        return params + moments + 4 + batch        # + the int32 step
    if shape.kind == "prefill":
        bspecs = S.batch_specs(specs, mesh)
        return params + sum(_local_bytes(t.shape, bspecs[k], mesh,
                                         t.element_size())
                            for k, t in specs.items())
    cspecs = S.cache_specs(specs["cache"], mesh, batch=shape.global_batch)
    cache = 0
    for name, c in specs["cache"].items():
        for f in ("k", "v"):
            t = getattr(c, f)
            cache += _local_bytes(t.shape, getattr(cspecs[name], f), mesh,
                                  t.element_size())
    per = shape.global_batch // mesh.shape["data"]
    return params + cache + per * 8 + 8            # int64 token, pos


@pytest.mark.parametrize("shape", CELLS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cell_is_ok_with_exact_argument_bytes(records, mesh, shape):
    rec = records[f"{mesh}/{shape}"]
    assert rec["status"] == "OK", rec
    assert rec["chips"] == math.prod(MESHES[mesh][0])
    assert rec["memory"]["argument_bytes"] == _hand_sum(
        shape, FakeMesh(*MESHES[mesh]))
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["memory"]["total_bytes"] == (rec["memory"]["argument_bytes"]
                                            + rec["memory"]["temp_bytes"])


@pytest.mark.parametrize("shape", CELLS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cell_records_collectives_and_roofline(records, mesh, shape):
    rec = records[f"{mesh}/{shape}"]
    coll = rec["collectives"]
    assert coll["n_ops"] > 0 and coll["total_wire_bytes"] > 0, coll
    assert sum(coll["by_kind"].values()) == pytest.approx(
        coll["total_wire_bytes"])
    assert isinstance(rec["fits_hbm"], bool)
    t = rec["roofline"]
    assert t["dominant"] in ("compute", "memory", "collective")
    assert t["flops"] == rec["cost"]["flops"] > 0
    assert t["chips"] == rec["chips"]


@pytest.mark.parametrize("mesh,k", [("single", 16), ("multi", 8)])
def test_train_cell_counts_its_microbatches(records, mesh, k):
    rec = records[f"{mesh}/train_4k"]
    assert rec["microbatches"] == k
    assert f"x{k}" in rec["multiplicity"]


def test_long_context_on_full_attention_is_skipped_as_the_reference():
    """The reference's reason, and no work done."""
    ok, why = ref_applicable(ref_get_config("qwen2.5-32b"),
                             REF_SHAPES["long_500k"])
    assert not ok
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("qwen2.5-32b", "long_500k", "single", save=False)
    assert rec == {"arch": "qwen2.5-32b", "shape": "long_500k",
                   "mesh": "single", "status": "SKIP", "reason": why}


def test_skip_in_the_subprocess_too(records):
    assert records["skip"]["status"] == "SKIP"
