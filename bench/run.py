"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the port (``src/repro_torch``).  The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` a ``breakdown``, and last the ``checks``: each number
compared, beside its limit); the last lines of standard error repeat the
checks.  It exits with 2, printing no result, without as many CUDA
devices as the cell asks for, and with 3 if JAX or the JAX package was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every cache the port or PyTorch may write stays inside the checkout, at a
# fixed path, so a cell's later runs find its kernels built.  (The port's
# own nvcc builds go to ROOT/build/repro_torch_kernels/, keyed by content.)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

#: Top-level module names the run may not load: JAX and the JAX package.
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules(names) -> list:
    """The forbidden top-level names among module names ``names``, each
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)


def _finite(v):
    return v if not isinstance(v, float) or math.isfinite(v) else str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from harness.cell import run_cell
    from harness.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    out = run_cell(cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda:0", t_start=T_START)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"loaded {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        c["value"] = _finite(c["value"])
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
