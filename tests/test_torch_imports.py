"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor anything of the JAX package, builds no kernel, and the
default-device entry points refuse to run without a card."""
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
print(json.dumps([len(names), leaked, len(_build._LIBS)]))
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, leaked, libs = json.loads(out.stdout.strip().splitlines()[-1])
    assert n >= 20, out.stdout               # every module was imported
    assert leaked == [], f"port imported {leaked}"
    assert libs == 0, "importing the port loaded a kernel library"


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
    assert K.LAUNCHES == {"spmv_sell": 0, "spmv_ellpack": 0, "spmv_ell": 0}
