"""Time the port's ``dot3`` beside other designs of the same kernel on one
CUDA card (``tools/dot3_variants.cu``: the port's dot3 before its redesign,
a persistent ring of bulk copies, and one block per chunk with plain loads
or bulk copies and three ways to finish).  Every design is first held to
``dot3_plain`` bit for bit; then each is timed with ``chip_smoke.cold_ms``
(a cold L2 before every call) at n = 10^6, 10^7 and 3·10^7, fp64 and fp32,
three times in a row, in the order listed and again in reverse.

    python3 tools/dot3_variants.py [--out chiprun_out/dot3_variants.json]

Prints the card's name and power limit first, one line per design and
size, and writes every time to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: name -> variant code of dot3_variant(); "port" is kernels.dot.dot3
DESIGNS = {"two_launch": 0, "port": None, "ring": 1, "plain_serial": 2,
           "plain_tree8": 3, "bulk_serial": 4, "bulk_two_launch": 5}
SIZES = (10**6, 10**7, 3 * 10**7)


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out = ROOT / "build" / "dot3_variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libdot3_variants.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I",
           str(ROOT / "src/repro_torch/kernels/csrc"), "-o", str(lib),
           str(ROOT / "tools/dot3_variants.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(done.stdout + done.stderr)
    fn = ctypes.CDLL(str(lib)).dot3_variant
    P = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, ctypes.c_int, P, P, P, ctypes.c_longlong,
                   P, P, P, P]
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "dot3_variants.json"))
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import dot as D
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    fn = build()
    dev = torch.device("cuda", 0)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)

    def call(name, r, u, w):
        if DESIGNS[name] is None:
            return D.dot3(r, u, w)
        n = r.shape[0]
        part = torch.empty(3 * D.n_chunks(n), dtype=r.dtype, device=dev)
        out = torch.empty(3, dtype=r.dtype, device=dev)
        err = fn(DESIGNS[name], 0 if r.dtype == torch.float64 else 1,
                 r.data_ptr(), u.data_ptr(), w.data_ptr(), n, part.data_ptr(),
                 out.data_ptr(), ticket.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out

    gen = torch.Generator().manual_seed(3)
    for dt in (torch.float64, torch.float32):
        for n in (1, 2049, 4097, 10**6 + 3, 10**7 + 1):
            for off in (0, 1):
                v = [torch.randn(n + off, generator=gen, dtype=dt).to(dev)[off:]
                     for _ in range(3)]
                want = D.dot3_plain(*v)
                for name in DESIGNS:
                    if not cs._bits(call(name, *v), want):
                        raise AssertionError(f"{name} {dt} n={n} offset "
                                             f"{off}: not dot3_plain's bits")
    print("every design equals dot3_plain bit for bit", flush=True)
    rows = []
    order = list(DESIGNS) + list(DESIGNS)[::-1]
    for dt in (torch.float64, torch.float32):
        for n in SIZES:
            v = [torch.randn(n, dtype=dt, device=dev) for _ in range(3)]
            b_ms, _ = cs.bound_ms(3 * n * v[0].element_size(), 6 * n, dt)
            for name in order:
                ms = [cs.cold_ms(lambda: call(name, *v)) for _ in range(3)]
                rows.append(dict(design=name, dtype=str(dt)[6:], n=n, ms=ms,
                                 bound_ms=b_ms))
                print(f"{str(dt)[6:]:8s} n={n:<9d} {name:16s} "
                      f"{' '.join(f'{t:.4f}' for t in ms)} ms "
                      f"(bound {b_ms:.4f}, {b_ms / min(ms):.1%})", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": cs.card_line(),
                                          "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
