"""Readings for the limits of ``correct``: a cell's compared numbers over
many seeds, in one process, for the port or for the control.

    python3 bench/control.py --workload <cell> --seconds <s> --program control --seeds 1 2 3
    python3 bench/control.py --workload <cell> --seconds <s> --program port --seeds 4 5 ...

``--program control`` puts the plain reference in the port's place, its
vectors one precision below the configuration's (the ``Control`` of the
configuration's program, ``bench/programs/<program>.py``); the check has
to find it not correct.  Each seed prints one JSON line: the seed,
``correct`` and the checks.  The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time

import run  # noqa: F401  (the checkout's paths and caches, as a run sets them)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program", choices=("port", "control"),
                    required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch
    from harness.cell import run_cell
    from harness.spec import load_cell

    if not torch.cuda.is_available():
        print("control.py measures on a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, run.ROOT)
    program = (cell.program.Control if args.program == "control"
               else cell.program.Port)
    for seed in args.seeds:
        out = run_cell(cell, seed=seed, seconds=args.seconds, trace=False,
                       device="cuda:0", t_start=time.perf_counter(),
                       program=program)
        checks = {k: run._finite(c["value"]) for k, c in
                  out["checks"].items()}
        print(json.dumps({"workload": args.workload, "program": args.program,
                          "seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"], "checks": checks,
                          "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
