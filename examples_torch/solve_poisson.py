"""End-to-end solver tour on the PyTorch/CUDA port: schemes × methods ×
backends + the stream VM.

Reproduces the paper's comparison structure on one problem:
  * default FP64 vs Mix-V1/V2/V3 (Table 1 / Fig. 9),
  * paper-faithful VSR loop vs beyond-paper pipelined CG,
  * the plain PyTorch backend vs the hand-written kernels (``pallas``:
    the CUDA SpMV, fused phases and dot on the card; their plain
    versions on the CPU),
  * the schedule→program pipeline: VSR schedules compiled to
    stream-ISA programs and executed on the batched VM (§3–5), with the
    19 → 14 → 13 HBM access-count story made concrete per policy.

    PYTHONPATH=src python examples_torch/solve_poisson.py [n_side]
    PYTHONPATH=src python examples_torch/solve_poisson.py 48 --device cpu
"""
import argparse

import numpy as np

from repro_torch.core.cg import jpcg_solve
from repro_torch.core.compile import compile_policy
from repro_torch.core.isa import derived_mem_instructions
from repro_torch.core.vm import vm_solve
from repro_torch.core.vsr import access_counts
from repro_torch.device import resolve_device
from repro_torch.sparse import poisson_2d


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n_side", nargs="?", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"schemes": {}, "methods": {}, "backends": {}, "vm": {}}

    A = poisson_2d(args.n_side)
    print(f"2-D Poisson, n={A.shape[0]}, nnz={A.nnz}\n")

    print("— precision schemes (paper Table 1) —")
    for scheme in ("fp64", "mixed_v3", "mixed_v2", "mixed_v1"):
        r = jpcg_solve(A, scheme=scheme, tol=1e-12, maxiter=20_000,
                       device=dev)
        print(f"  {scheme:9s}: iters={r.iterations:5d} "
              f"converged={r.converged}")
        out["schemes"][scheme] = r

    print("\n— methods (paper VSR vs beyond-paper pipelined) —")
    for method in ("vsr", "pipelined"):
        r = jpcg_solve(A, scheme="mixed_v3", method=method, tol=1e-12,
                       maxiter=20_000, device=dev)
        print(f"  {method:9s}: iters={r.iterations:5d} rr={r.rr:.2e}")
        out["methods"][method] = r

    print(f"\n— backends (plain PyTorch vs the kernels, on {dev.type}) —")
    for backend in ("xla", "pallas"):
        r = jpcg_solve(A, scheme="mixed_v3", backend=backend, tol=1e-12,
                       maxiter=20_000, block_rows=128, col_tile=256,
                       device=dev)
        print(f"  {backend:9s}: iters={r.iterations:5d} rr={r.rr:.2e}")
        out["backends"][backend] = r

    print("\n— schedule → program → batched VM (paper §3–5) —")
    c = access_counts()
    print(f"  VSR accounting: naive {c['naive']['total']} -> paper "
          f"{c['paper']['total']} -> min-traffic "
          f"{c['min_traffic']['total']}")

    # The same system, solved through the phase-fused production loop and
    # through a compiled min-traffic program on the stream VM: identical
    # iterate path, two HBM traffic schedules.
    ref = jpcg_solve(A, scheme="mixed_v3", tol=1e-12, maxiter=20_000,
                     device=dev)
    print(f"  phase loop  : iters={ref.iterations:5d} rr={ref.rr:.2e}  "
          f"(implicit schedule, fused phases)")
    out["phase_loop"] = ref
    for policy in ("paper", "min_traffic"):
        cp = compile_policy(policy)
        mem = derived_mem_instructions(cp.program)
        res = vm_solve(A, program=cp.program, tol=1e-12, maxiter=20_000,
                       device=dev)
        print(f"  vm[{policy:11s}]: program={cp.length} instrs "
              f"(Type-III: {mem['reads']}R+{mem['writes']}W)  "
              f"iters={res['iterations']} rr={res['rr']:.2e}")
        out["vm"][policy] = res

    naive = c["naive"]
    paper = derived_mem_instructions(compile_policy("paper").program)
    mint = derived_mem_instructions(compile_policy("min_traffic").program)
    print(f"\n  HBM vector accesses per iteration: naive {naive['total']} "
          f"-> paper VSR {paper['total']} -> min-traffic {mint['total']}")
    print(f"  compiled delta vs naive : paper saves "
          f"{naive['total'] - paper['total']}, min-traffic saves "
          f"{naive['total'] - mint['total']} "
          f"(one fewer read than the paper: r' stores straight from "
          f"phase 2)")

    x = res["x"].cpu().numpy()
    out["solution_norm"] = float(np.linalg.norm(x))
    print(f"\nsolution norm: {out['solution_norm']:.6f}")
    return out


if __name__ == "__main__":
    main()
