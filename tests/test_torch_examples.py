"""The port's examples (``examples_torch/``) on the CPU, against the
reference's functions.

Each example's ``main`` runs in-process with ``--device cpu`` at small
arguments.  For the same matrices and schemes, its solver figures are held
against the reference's ``repro.core.cg.jpcg_solve`` and
``repro.core.vm.vm_solve`` (the reference's scripts run at import, so
they are not run): the converged flags equal, the iterations within ±1,
and ±2 for ``pipelined`` (its dot products sum in another order).
``serve_decode``'s decode token counts equal the reference's
``DecodeEngine``'s over the same requests; ``train_lm_cggn --size 25m``
lowers the loss under AdamW and under CGGN.  Without a card each example
raises before any work.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

from repro.configs import get_config as ref_get_config
from repro.core.cg import jpcg_solve as ref_jpcg_solve
from repro.core.compile import compile_policy as ref_compile_policy
from repro.core.vm import vm_solve as ref_vm_solve
from repro.models import init_params as ref_init_params
from repro.serve import DecodeEngine as RefEngine
from repro.serve import EngineConfig as RefEngineConfig
from repro.sparse import poisson_2d as ref_poisson_2d

EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"
NAMES = ("quickstart", "solve_poisson", "serve_decode", "train_lm_cggn")
#: the solver tour's grid (the script's default is 48; the reference's
#: pallas backend runs its kernels in interpret mode here)
N_SIDE = 16
TRAIN_ARGS = ["--size", "25m", "--steps", "30", "--cggn-steps", "3",
              "--seq-len", "32", "--batch", "4", "--device", "cpu"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got_iters, got_conv, want, slack=1):
    """(iterations, converged) of the port against a reference result."""
    if isinstance(want, dict):
        w_it, w_conv = int(want["iterations"]), bool(want["converged"])
    else:
        w_it, w_conv = want.iterations, want.converged
    assert got_conv == w_conv and abs(got_iters - w_it) <= slack, \
        (got_iters, got_conv, w_it, w_conv)


# ------------------------------------------------------------ quickstart
@pytest.fixture(scope="module")
def quickstart():
    return _load("quickstart").main(["--device", "cpu"])


@pytest.mark.parametrize("scheme", ["mixed_v3", "fp64", "mixed_v1"])
def test_quickstart_matches_reference(quickstart, scheme):
    got = quickstart[scheme]
    _close(got.iterations, got.converged,
           ref_jpcg_solve(ref_poisson_2d(64), scheme=scheme, tol=1e-12,
                          maxiter=20_000))


def test_quickstart_true_residual(quickstart):
    assert quickstart["mixed_v3"].converged
    assert quickstart["true_resid"] < 1e-5


# --------------------------------------------------------- solve_poisson
@pytest.fixture(scope="module")
def tour():
    return _load("solve_poisson").main([str(N_SIDE), "--device", "cpu"])


@pytest.mark.parametrize("scheme", ["fp64", "mixed_v3", "mixed_v2",
                                    "mixed_v1"])
def test_tour_schemes_match_reference(tour, scheme):
    got = tour["schemes"][scheme]
    _close(got.iterations, got.converged,
           ref_jpcg_solve(ref_poisson_2d(N_SIDE), scheme=scheme, tol=1e-12,
                          maxiter=20_000))


@pytest.mark.parametrize("method", ["vsr", "pipelined"])
def test_tour_methods_match_reference(tour, method):
    got = tour["methods"][method]
    _close(got.iterations, got.converged,
           ref_jpcg_solve(ref_poisson_2d(N_SIDE), scheme="mixed_v3",
                          method=method, tol=1e-12, maxiter=20_000),
           slack=2 if method == "pipelined" else 1)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_tour_backends_match_reference(tour, backend):
    got = tour["backends"][backend]
    _close(got.iterations, got.converged,
           ref_jpcg_solve(ref_poisson_2d(N_SIDE), scheme="mixed_v3",
                          backend=backend, tol=1e-12, maxiter=20_000,
                          block_rows=128, col_tile=256))


@pytest.mark.parametrize("policy", ["paper", "min_traffic"])
def test_tour_vm_matches_reference(tour, policy):
    got = tour["vm"][policy]
    _close(int(got["iterations"]), bool(got["converged"]),
           ref_vm_solve(ref_poisson_2d(N_SIDE),
                        program=ref_compile_policy(policy).program,
                        tol=1e-12, maxiter=20_000))
    # the compiled min-traffic program walks the phase loop's iterates
    assert int(got["iterations"]) == tour["phase_loop"].iterations


# ---------------------------------------------------------- serve_decode
@pytest.fixture(scope="module")
def served():
    return _load("serve_decode").main(["--device", "cpu"])


def _ref_decode_ticks(arch, n_requests=6, max_new=32):
    """The reference's engine over the example's requests."""
    cfg = ref_get_config(arch).reduced()
    eng = RefEngine(cfg, ref_init_params(cfg, jax.random.PRNGKey(0)),
                    RefEngineConfig(batch_slots=4, max_len=512,
                                    temperature=0.7, cache_dtype="float32"))
    rng = np.random.default_rng(0)
    pending = [[int(t) for t in rng.integers(1, cfg.vocab, size=k)]
               for k in rng.integers(4, 12, size=n_requests)]
    ticks = 0
    while pending or eng.active.any():
        while pending and (~eng.active).any():
            eng.add_request(pending.pop(), max_new=max_new)
        ticks += len(eng.step())
    return ticks


@pytest.mark.parametrize("i,arch", [(0, "mamba2-780m"),
                                    (1, "h2o-danube-3-4b")])
def test_serve_decode_counts_match_reference(served, i, arch):
    got = served[i]
    assert got["arch"] == arch
    assert got["tokens"] == _ref_decode_ticks(arch)
    # every request got its max_new tokens in a slot's outputs
    assert all(len(o) == 32 for o in got["outputs"] if o)


# --------------------------------------------------------- train_lm_cggn
def test_train_lm_cggn_loss_falls_under_both_optimizers():
    out = _load("train_lm_cggn").main(TRAIN_ARGS)
    adamw = [r["loss"] for r in out["adamw"]]
    cggn = [r["loss"] for r in out["cggn"]]
    assert len(adamw) == 30 and len(cggn) == 3
    assert np.all(np.isfinite(adamw + cggn))
    assert adamw[-1] < adamw[0] and cggn[-1] < cggn[0]
    assert all(r["delta_norm"] <= 2.0 * (1 + 1e-6) for r in out["cggn"])


# -------------------------------------------------------- without a card
@pytest.mark.parametrize("name", NAMES)
def test_example_defaults_to_cuda_and_refuses_without_card(monkeypatch,
                                                           name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load(name).main([])
