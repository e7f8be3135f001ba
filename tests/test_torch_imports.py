"""The port stands alone: importing every ``repro_torch`` module, or any
of its examples (``examples_torch/``), pulls in neither JAX nor anything
of the JAX package, builds no kernel, and the default-device entry points
refuse to run without a card."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
from repro_torch.kernels import _build
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "repro" or m.startswith("repro."))
import torch.distributed as dist
print(json.dumps([len(names), leaked, len(_build._LIBS),
                  sorted(set(NEEDED) - set(names)),
                  dist.is_available() and dist.is_initialized()]))
"""
#: modules the probe must find (and import) among the port's
NEEDED = ("repro_torch.sparse.mtx", "repro_torch.core.shard",
          "repro_torch.sparse.partition", "repro_torch.distributed",
          "repro_torch.distributed.cg_dist", "repro_torch.core.gn",
          "repro_torch.train", "repro_torch.train.cggn",
          "repro_torch.train.optim", "repro_torch.train.data",
          "repro_torch.train.checkpoint", "repro_torch.train.fault",
          "repro_torch.train.loop", "repro_torch.launch.train",
          "repro_torch.models.moe", "repro_torch.models.ssm",
          "repro_torch.models.hybrid", "repro_torch.models.encdec",
          "repro_torch.serve.quant_cache", "repro_torch.roofline",
          "repro_torch.roofline.model", "repro_torch.roofline.torch_cost",
          "repro_torch.roofline.collectives", "repro_torch.roofline.report",
          "repro_torch.distributed.sharding", "repro_torch.distributed.hints",
          "repro_torch.launch.mesh", "repro_torch.launch.dryrun")


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    probe = f"NEEDED = {NEEDED!r}\n" + _PROBE
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, leaked, libs, missing, pg = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert n >= 20 and missing == [], out.stdout   # every module imported
    assert leaked == [], f"port imported {leaked}"
    assert libs == 0, "importing the port loaded a kernel library"
    assert not pg, "importing the port started a process group"


_EXAMPLES_PROBE = """
import importlib.util, json, sys
from pathlib import Path
loaded = []
for path in sorted(Path(sys.argv[1]).glob("*.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    loaded.append(path.stem)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "repro" or m.startswith("repro."))
print(json.dumps([loaded, leaked]))
"""


def test_examples_import_neither_jax_nor_reference():
    """Loading every ``examples_torch`` script (its imports; ``main`` does
    not run) pulls in neither JAX nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _EXAMPLES_PROBE,
                          str(SRC.parent / "examples_torch")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded, leaked = json.loads(out.stdout.strip().splitlines()[-1])
    assert loaded == ["quickstart", "serve_decode", "solve_poisson",
                      "train_lm_cggn"]
    assert leaked == [], f"examples imported {leaked}"


_FLASH_PROBE = """
import json, sys, torch
from repro_torch.kernels import _build, flash_attn as FA
x = torch.zeros((2, 64, 64), dtype=torch.bfloat16)
f, f18 = x.float(), x[..., :18].float().contiguous()
routes = [FA._route(x, x, x), FA._route(x[..., :20].contiguous(), x, x),
          FA._route(f, f, f), FA._route(f18, f18, f18)]
out = FA.flash_attention(x, x, x, block_q=64, block_k=64)
out32 = FA.flash_attention(f, f, f, block_q=64, block_k=64)
sources = sorted(p.stem for p in _build._CSRC.glob("flash_attn*.cu"))
print(json.dumps([routes, len(_build._LIBS),
                  out.shape == out32.shape == x.shape, sources]))
"""


def test_flash_wrapper_without_nvcc(tmp_path):
    """The flash wrapper imports, routes and takes its plain version on the
    CPU with no ``nvcc`` to be found (``PATH`` and ``CUDA_HOME`` point
    nowhere), building nothing; its three CUDA sources are in ``csrc``."""
    env = dict(os.environ, PYTHONPATH=str(SRC), PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", _FLASH_PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    routes, libs, shaped, sources = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert routes == ["wgmma", "mma_sync", "tf32x3", "fp32"]
    assert libs == 0 and shaped
    assert sources == ["flash_attn", "flash_attn_sm90", "flash_attn_tf32"]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_solver_defaults_to_cuda_and_refuses_without_card(no_card):
    from repro_torch.core.batch import jpcg_solve_batched
    from repro_torch.sparse import poisson_2d
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jpcg_solve_batched([poisson_2d(4)])


def test_engine_defaults_to_cuda_and_refuses_without_card(no_card):
    from repro_torch.serve import SolverEngine, SolverEngineConfig
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SolverEngine(SolverEngineConfig())


def test_convert_defaults_to_cuda_and_refuses_without_card(no_card):
    from repro_torch import convert
    from repro_torch.core.precision import get_scheme
    from repro_torch.sparse import poisson_2d, stack_rowell
    st = stack_rowell([poisson_2d(4)], scheme=get_scheme("fp64"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.stacked_to_torch(st)


def test_explicit_cpu_runs_plain_path(no_card):
    from repro_torch.core.batch import jpcg_solve_batched
    from repro_torch.kernels import spmv as K
    from repro_torch.sparse import poisson_2d
    K.reset_launches()
    res = jpcg_solve_batched([poisson_2d(4)], device="cpu")
    assert res[0].status == "CONVERGED" and res[0].x.device.type == "cpu"
    assert np.isfinite(res[0].rr)
    assert {"spmv_sell", "spmv_ellpack", "spmv_ell"} <= set(K.LAUNCHES)
    assert K.LAUNCHES == dict.fromkeys(K.LAUNCHES, 0)


def test_training_entry_points_default_to_cuda_and_refuse_without_card(
        no_card):
    from repro_torch.launch import train as launch
    from repro_torch.models.config import ModelConfig
    from repro_torch.train import DataConfig, SyntheticLM, make_train_step
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=8,
                      n_heads=1, n_kv_heads=1, d_ff=8, vocab=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLM(DataConfig(vocab=8, seq_len=4, global_batch=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "gemma3-1b", "--steps", "1"])


def test_default_cuda_device_carries_its_index(monkeypatch):
    """``jpcg_solve(a)`` on the card compares its operator's device
    (``cuda:0``) with the resolved one, so ``"cuda"`` and the default
    resolve to the current device with its index."""
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device(torch.device("cuda")) == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
