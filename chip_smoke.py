#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py        # full size, all four phases; takes no options

1. Kernels against their plain PyTorch versions on the card: the SELL
   kernel in row-ELL form (one group) and multi-group form, the ELLPACK
   kernel, every faithful scheme, int16 and int32 indices — bitwise equal.
   Times each kernel, its plain version and an fp64 block-diagonal CSR
   ``torch.sparse.mm`` of the same bag (a yardstick only, never called by
   the port; the kernels run mixed_v3), beside two bounds at 3.35 TB/s:
   ``bound_ms`` for the bag's nonzeros at their at-rest widths, and
   ``bound_stored_ms`` for every stored slot of the padded layout.
2. The batched solve (``jpcg_solve_batched``) at full size — a bag of
   G = 8 lanes from the large tier of the paper's Table 3 classes (n up to
   250,000, n_pad 262,144): VM ≡ phases bitwise under mixed_v3 (SELL) and
   fp64, and the ELLPACK and row-ELL layouts on the Poisson lanes; every
   lane CONVERGED with a true residual ‖Ax−b‖/‖b‖ ≤ 1e-6 on the host in
   fp64.  The VM loop is also timed alone on pre-packed operands, and
   profiled once (device time by kernel, busy share).
3. ``SolverEngine``: ~10 requests of mixed sizes plus one singular lane;
   the singular lane exits BREAKDOWN_INDEFINITE at iteration 0, the rest
   converge, ``bytes_streamed_est`` equals the packed-array accounting.
4. The same small bag through the port on the card and on the CPU.
5. The single-system kernels against their plain versions on the card,
   bitwise: ``spmv_ell`` (the ELLPACK kernel at G = 1) on
   ``poisson_2d(1000)`` for every faithful scheme; ``dot``, ``dot3``,
   ``phase2`` and ``phase3`` at fp32 and fp64 on vectors of n = 10^6 and
   of ragged lengths.  Each is timed at n = 10^6 (fp64; the SpMV at
   mixed_v3) with a cold, clean L2 before every call, beside its plain
   version, its bound at 3.35 TB/s and, where one PyTorch call computes
   the same function, that call (``torch.dot``; an fp64 CSR
   ``torch.sparse.mm`` for the SpMV).
6. The single-system solve (``jpcg_solve``) at full size on
   ``poisson_2d(1000)`` (n = 1,000,000, 4,996,000 nonzeros; b = 1,
   x0 = 0, tol 1e-12, maxiter 20,000): ``vsr`` × ``pallas`` at mixed_v3
   and fp64, ``vsr`` × ``xla`` and ``pipelined`` × ``xla`` at mixed_v3.
   Every solve converges to a true residual ≤ 1e-6; at mixed_v3 the
   ``pallas`` and ``xla`` VSR solves agree (iterations ±1, x within
   rtol 1e-4, atol 1e-6) and the pipelined x agrees with them.  Each is
   timed as a call from the CSR and as the loop alone on a pre-built
   operator; the mixed_v3 ``pallas`` loop is profiled once.

Launch counters are set to 0 right before the solves of phases 2, 3 and
6 and read right after; each kernel of a path must have launched on it
(``dot3`` has no solver path: phase 5 launches it).  Any failed check
raises.  The last line is the JSON result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}   # H100 SXM, no tensor cores
SCHEMES = ("fp64", "mixed_v1", "mixed_v2", "mixed_v3")
SOLVE_TOL = 1e-12
RESIDUAL_MAX = 1e-6


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ data
def smoke_bag():
    """The G = 8 smoke bag: 4 × poisson_2d(500), 2 × diag_dominant_spd
    (the bmwcra_1 class), 2 × powerlaw_spd (skewed rows)."""
    from repro_torch.sparse import diag_dominant_spd, poisson_2d, powerlaw_spd
    poisson = poisson_2d(500)
    return ([poisson] * 4
            + [diag_dominant_spd(148770, nnz_per_row=70, dominance=1.1,
                                 seed=s) for s in (4, 14)]
            + [powerlaw_spd(131072, alpha=2.1, max_deg=1024, seed=s)
               for s in (5, 6)])


def int16_bag():
    """A bag whose bucketed rows stay under 2^15: int16 indices."""
    from repro_torch.sparse import diag_dominant_spd, poisson_2d, powerlaw_spd
    return [poisson_2d(120), diag_dominant_spd(16000, nnz_per_row=30,
                                               dominance=1.1, seed=3),
            powerlaw_spd(16384, alpha=2.1, max_deg=512, seed=7)]


def singular_j(n):
    """All-ones J_n (rank 1) with a sum-zero rhs: pAp = 0 on tick 1."""
    import numpy as np
    from repro_torch.sparse import csr_from_coo
    i = np.repeat(np.arange(n), n)
    j = np.tile(np.arange(n), n)
    a = csr_from_coo(i, j, np.ones(n * n), (n, n))
    b = np.zeros(n)
    b[0], b[1] = 1.0, -1.0
    return a, b


def residual(a, x, b=None):
    """‖Ax − b‖ / ‖b‖ on the host in fp64 from the CSR."""
    import numpy as np
    from repro_torch.sparse.csr import csr_spmv
    x = x.detach().cpu().numpy().astype(np.float64)
    b = np.ones(a.shape[0]) if b is None else b
    return float(np.linalg.norm(csr_spmv(a, x) - b) / np.linalg.norm(b))


# --------------------------------------------------------------- timing
def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(bytes_moved: int, flops: int, acc_dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(acc_dtype).split(".")[-1]] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def block_diag_csr(csrs, n_pad, device, dtype):
    """Block-diagonal torch CSR of a bag, each lane padded to n_pad rows."""
    import numpy as np
    import torch
    crow, cols, vals, base = [np.zeros(1, np.int64)], [], [], 0
    for g, a in enumerate(csrs):
        ip = np.full(n_pad + 1, a.indptr[-1], np.int64)
        ip[: a.shape[0] + 1] = a.indptr
        crow.append(ip[1:] + base)
        cols.append(a.indices.astype(np.int64) + g * n_pad)
        vals.append(a.data)
        base += a.nnz
    n = len(csrs) * n_pad
    return torch.sparse_csr_tensor(
        torch.from_numpy(np.concatenate(crow)),
        torch.from_numpy(np.concatenate(cols)),
        torch.from_numpy(np.concatenate(vals)), (n, n)).to(
            device=device, dtype=dtype)


# -------------------------------------------------------------- phase 1
def _same(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def phase_kernels(bag, dev):
    """Every kernel against its plain version on the card, bitwise."""
    import numpy as np
    import torch
    from repro_torch.core.batch import stack_operands
    from repro_torch.core.precision import get_scheme
    from repro_torch.kernels import spmv as K

    gen = torch.Generator(device="cpu").manual_seed(0)
    fp64 = get_scheme("fp64")
    poisson = bag[:4]
    cases = []   # (label, kernel, csrs, layout, backend)
    for csrs, tag in ((bag, "main"), (int16_bag(), "int16")):
        cases.append((f"sell/{tag}", "spmv_sell", csrs, "sell", "xla"))
    cases.append(("rowell/poisson", "spmv_sell", poisson, "rowell", "xla"))
    cases.append(("rowell/int16", "spmv_sell", int16_bag(), "rowell", "xla"))
    cases.append(("ellpack/poisson", "spmv_ellpack", poisson, "ellpack",
                  "pallas"))
    cases.append(("ellpack/int16bag", "spmv_ellpack", int16_bag(), "ellpack",
                  "pallas"))
    timed = {}
    for label, kname, csrs, layout, backend in cases:
        t0 = time.perf_counter()
        mat, stacked, groups, n_ct, _ = stack_operands(
            csrs, backend=backend, layout=layout, scheme=fp64, device=dev)
        pack_s = time.perf_counter() - t0
        n_pad = stacked.padded_rows
        G = len(csrs)
        x = torch.randn((G, n_pad), generator=gen,
                        dtype=torch.float64).to(dev)
        for name in SCHEMES:
            sch = get_scheme(name)
            in_el = torch.empty((), dtype=sch.spmv_in_dtype).element_size()
            if layout == "ellpack":
                tc, v64, lc = mat
                v = v64.to(sch.matrix_dtype)
                C = stacked.col_tile
                xt = torch.zeros((G, n_ct * C), dtype=torch.float64,
                                 device=dev)
                k = min(n_pad, n_ct * C)
                xt[:, :k] = x[:, :k]
                xt = xt.reshape(G, n_ct, C)
                args = (tc, v, lc, xt)
                kern, plain = K.spmv_ellpack, K.spmv_ellpack_plain
                kw = dict(scheme=sch)
                in_b = xt.numel() * in_el
                stream = (tc, v, lc)
            else:
                cols, v64 = mat[0], mat[1]
                Gd = cols.shape[0]
                cols = cols.reshape(Gd, -1)
                v = v64.reshape(Gd, -1).to(sch.matrix_dtype)
                grp = groups if layout == "sell" else ((n_pad,
                                                        mat[0].shape[1]),)
                args = (cols, v, x)
                kern, plain = K.spmv_sell, K.spmv_sell_plain
                kw = dict(groups=grp, scheme=sch)
                in_b = x.numel() * in_el
                stream = (cols, v)
            y_k = kern(*args, **kw)
            y_p = plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            if not _same(y_k, y_p):
                raise AssertionError(
                    f"{label}/{name}: kernel differs from its plain version "
                    f"(max |Δ| {err})")
            idx = "int16" if stream[0].dtype == torch.int16 else "int32"
            log(f"  {label:18s} {name:8s} {idx}: bitwise equal "
                f"(G={G}, n_pad={n_pad}, stream {nbytes(*stream)} B, "
                f"pack {pack_s:.2f} s)")
            main = (name == "mixed_v3" and label in ("sell/main",
                                                     "ellpack/poisson"))
            if not main:
                continue
            # bound_ms counts what this bag needs: its nonzeros' values and
            # indices at their at-rest widths, x read and y written once
            # per row.  bound_stored_ms counts every stored slot of the
            # padded layout (what the kernel streams), x and y as allocated.
            nnz = sum(a.nnz for a in csrs)
            rows = sum(a.shape[0] for a in csrs)
            idx_t = stream[-1] if layout == "ellpack" else stream[0]
            need = (nnz * (v.element_size() + idx_t.element_size())
                    + rows * (in_el + y_k.element_size()))
            b_ms, b_by = bound_ms(need, 2 * nnz, sch.spmv_acc_dtype)
            slots = stream[1].numel()
            moved = nbytes(*stream) + in_b + nbytes(y_k)
            st_ms, _ = bound_ms(moved, 2 * slots, sch.spmv_acc_dtype)
            ms = cuda_ms(lambda: kern(*args, **kw))
            plain_ms = cuda_ms(lambda: plain(*args, **kw))
            A = block_diag_csr(csrs, n_pad if layout != "ellpack"
                               else n_ct * stacked.col_tile,
                               dev, torch.float64)
            xs = (x if layout != "ellpack" else xt).reshape(-1, 1)
            lib_ms = cuda_ms(lambda: torch.sparse.mm(A, xs))
            timed[kname] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, library_dtype="float64",
                bound_stored_ms=st_ms, shape=label, nnz=nnz, slots=slots)
            log(f"    {kname}: {ms:.3f} ms (plain {plain_ms:.3f}, fp64 "
                f"torch.sparse.mm {lib_ms:.3f}); bound {b_ms:.4f} ms by "
                f"{b_by} for {nnz} nonzeros ({need} B, {b_ms / ms:.1%}); "
                f"stored-slot bound {st_ms:.4f} ms for {slots} slots "
                f"({moved} B, {moved / ms / 1e6:.1f} GB/s, "
                f"{st_ms / ms:.1%})")
            del A
    return timed


# -------------------------------------------------------------- phase 2
def _solve(bag, dev, **kw):
    import torch
    from repro_torch.core.batch import jpcg_solve_batched
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = jpcg_solve_batched(bag, tol=SOLVE_TOL, device=dev, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _loop_run(csrs, dev, scheme, backend, layout):
    """The VM solve loop alone on pre-packed operands: the runner that
    ``jpcg_solve_batched(engine="vm")`` builds, and its inputs."""
    import numpy as np
    import torch
    from repro_torch.core.batch import _pad_stack, stack_operands
    from repro_torch.core.compile import canonical_program
    from repro_torch.core.precision import get_scheme
    from repro_torch.core.vm import make_vm_runner
    sch = get_scheme(scheme)
    mat, stacked, groups, n_ct, _ = stack_operands(
        csrs, backend=backend, layout=layout, scheme=sch, device=dev)
    n_pad, vd = stacked.padded_rows, sch.vector_dtype
    run = make_vm_runner(backend=backend, scheme=sch, maxiter=20_000,
                         with_trace=False, layout=layout, groups=groups,
                         col_tile=512, n_col_tiles=n_ct,
                         program=canonical_program("paper"))
    args = (mat, _pad_stack([a.diagonal() for a in csrs], n_pad, 1.0, vd,
                            dev),
            _pad_stack([np.ones(a.shape[0]) for a in csrs], n_pad, 0.0, vd,
                       dev),
            torch.zeros((len(csrs), n_pad), dtype=vd, device=dev),
            torch.full((len(csrs),), SOLVE_TOL, dtype=vd, device=dev))
    return run, args


def _timed(run, args):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(*args)
    torch.cuda.synchronize()
    return st, time.perf_counter() - t0


def device_profile(fn):
    """Run ``fn`` once under torch.profiler; ``(result, wall_s, events)``
    with one ``(kernel, device ms, count)`` per CUDA kernel name.  Only
    kernel events are kept: operator events repeat their kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import torch
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [(e.key, e.self_device_time_total / 1e3, e.count)
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    return out, wall, ev


def profile_loop(run, args, loop_s: float) -> dict:
    """Device time by kernel over one whole VM solve (torch.profiler).

    The busy share is against ``loop_s``, the same solve timed without
    the profiler, whose host-side cost slows the launches.
    """
    st, wall, ev = device_profile(lambda: run(*args))
    ticks = int(st.k)
    busy_ms = sum(t for _, t, _ in ev)
    n_kernels = sum(c for _, _, c in ev)
    log(f"    profile: {ticks} ticks, {n_kernels} kernels "
        f"({n_kernels / ticks:.1f}/tick), device busy {busy_ms:.1f} ms = "
        f"{busy_ms / ticks:.3f} ms/tick = {busy_ms / 1e3 / loop_s:.1%} of "
        f"the unprofiled loop ({loop_s:.3f} s; {wall:.3f} s profiled)")
    for key, t, c in sorted(ev, key=lambda e: -e[1])[:8]:
        log(f"      {t:9.1f} ms {c:7d}x  {key[:90]}")
    return dict(busy_ms=busy_ms, ticks=ticks, kernels=n_kernels)


def phase_solve(bag, dev):
    """VM ≡ phases on the card, every lane converged to a true residual;
    the loop timed alone on pre-packed operands, and profiled once."""
    import torch
    from repro_torch.sparse.stacking import choose_layout

    rows = []
    runs = [("mixed_v3", "xla", bag), ("fp64", "xla", bag),
            ("mixed_v3", "pallas", bag[:4]), ("mixed_v3", "xla", bag[:4])]
    for n_run, (scheme, backend, csrs) in enumerate(runs):
        layout = choose_layout(
            csrs, default="rowell" if backend == "xla" else "ellpack")
        out = {}
        for engine in ("vm", "phases"):
            out[engine] = _solve(csrs, dev, scheme=scheme, backend=backend,
                                 engine=engine)
        (vm, t_vm), (ph, t_ph) = out["vm"], out["phases"]
        for g, (a, r_v, r_p) in enumerate(zip(csrs, vm, ph)):
            if not (r_v.iterations == r_p.iterations
                    and r_v.status == r_p.status
                    and _same(r_v.x, r_p.x)):
                raise AssertionError(
                    f"{scheme}/{layout} lane {g}: VM differs from phases "
                    f"({r_v.iterations} vs {r_p.iterations})")
            res = residual(a, r_v.x)
            if r_v.status != "CONVERGED" or res > RESIDUAL_MAX:
                raise AssertionError(
                    f"{scheme}/{layout} lane {g}: {r_v.status}, true "
                    f"residual {res:.3e}")
        t0 = time.perf_counter()
        run, args = _loop_run(csrs, dev, scheme, backend, layout)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        st, loop_s = _timed(run, args)
        ticks = int(st.k)
        its = [r.iterations for r in vm]
        if st.it.cpu().tolist() != its:
            raise AssertionError(f"{scheme}/{layout}: loop-only run took "
                                 f"{st.it.cpu().tolist()} iterations")
        row = dict(scheme=scheme, layout=layout, G=len(csrs),
                   iterations=its, vm_s=t_vm, phases_s=t_ph, pack_s=pack_s,
                   loop_s=loop_s, systems_per_s=len(csrs) / t_vm,
                   iterations_per_s=max(its) / t_vm,
                   loop_systems_per_s=len(csrs) / loop_s,
                   ms_per_tick=loop_s / ticks * 1e3,
                   max_residual=max(residual(a, r.x)
                                    for a, r in zip(csrs, vm)))
        rows.append(row)
        log(f"  {scheme}/{layout} G={len(csrs)}: iterations {its}; "
            f"jpcg_solve_batched vm {t_vm:.3f} s, phases {t_ph:.3f} s "
            f"({row['systems_per_s']:.3f} systems/s, "
            f"{row['iterations_per_s']:.1f} iterations/s); packing "
            f"{pack_s:.3f} s; loop alone {loop_s:.3f} s over {ticks} ticks "
            f"= {row['ms_per_tick']:.3f} ms/tick "
            f"({row['loop_systems_per_s']:.2f} systems/s); max residual "
            f"{row['max_residual']:.2e}; VM ≡ phases bitwise")
        if n_run in (0, 2):
            profile_loop(run, args, loop_s)
    return rows


# -------------------------------------------------------------- phase 3
def _lane_bytes(pool) -> int:
    """Packed-array accounting: a lane's values + indices as stored."""
    stream = pool.mat[1:3] if (pool.cfg.backend == "pallas"
                               and pool.layout != "sell") else pool.mat[:2]
    return nbytes(*stream) // pool.slots


def phase_engine(bag, dev):
    """SolverEngine: mixed requests + one singular lane."""
    import numpy as np
    from repro_torch.serve import SolverEngine, SolverEngineConfig
    from repro_torch.sparse import diag_dominant_spd, poisson_2d

    poisson, diag4, diag14, pl5, pl6 = bag[0], bag[4], bag[5], bag[6], bag[7]
    mid_poisson = poisson_2d(300)
    mid_diag = diag_dominant_spd(60000, nnz_per_row=70, dominance=1.1,
                                 seed=24)
    J, bJ = singular_j(64)
    # (matrix, rhs, scheme override); the mixed_v3 pool resolves to SELL
    # (its first admit is skewed), the fp64 pool to ELLPACK (its first
    # admit is a stencil).
    reqs = [(pl5, None, None), (poisson, None, None), (diag4, None, None),
            (J, bJ, None), (pl6, None, None), (diag14, None, None),
            (mid_diag, None, None), (mid_poisson, None, None),
            (poisson, None, "fp64"), (poisson, None, "fp64"),
            (mid_poisson, None, "fp64")]
    eng = SolverEngine(SolverEngineConfig(batch_slots=8, chunk_iters=64,
                                          backend="pallas", device=str(dev)))
    admit_bytes = 0
    rids = {}
    t0 = time.perf_counter()
    for a, b, scheme in reqs:
        rid = eng.submit(a, b, scheme=scheme)
        pool = eng._pool(scheme, None)
        admit_bytes += _lane_bytes(pool)
        rids[rid] = (a, b, pool)
    admit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    done = eng.run_to_completion()
    run_s = time.perf_counter() - t0
    if set(done) != set(rids):
        raise AssertionError(f"missing results: {set(rids) - set(done)}")
    expected = admit_bytes
    layouts = {}
    for rid, (a, b, pool) in rids.items():
        r = done[rid]
        layouts[f"{pool.scheme.name}/{pool.layout}"] = pool.slots
        events = r.iterations
        if r.status in ("BREAKDOWN_INDEFINITE", "BREAKDOWN_NONFINITE") \
                and np.isfinite(r.rr):
            events += 1
        expected += events * _lane_bytes(pool)
        if a is J:
            if r.status != "BREAKDOWN_INDEFINITE" or r.iterations != 0:
                raise AssertionError(f"singular lane: {r.status} at "
                                     f"iteration {r.iterations}")
            continue
        res = residual(a, r.x, b)
        if r.status != "CONVERGED" or res > RESIDUAL_MAX:
            raise AssertionError(f"request {rid}: {r.status}, residual "
                                 f"{res:.3e}")
    m = eng.metrics()
    if m["bytes_streamed_est"] != expected:
        raise AssertionError(f"bytes_streamed_est {m['bytes_streamed_est']}"
                             f" != packed-array accounting {expected}")
    its = sorted(r.iterations for r in done.values())
    log(f"  engine: {len(reqs)} requests (pools {sorted(layouts)}), admit "
        f"{admit_s:.2f} s, run {run_s:.2f} s, iterations {its}, "
        f"bytes_streamed_est {m['bytes_streamed_est']} == expected, "
        f"chunks {m.get('chunks')}, compactions {m.get('compactions', 0)}, "
        f"growths {m.get('growths', 0)}, exits {m['exit_status']}")
    return dict(requests=len(reqs), admit_s=admit_s, run_s=run_s,
                iterations=its, bytes_streamed_est=m["bytes_streamed_est"])


# -------------------------------------------------------------- phase 4
def phase_cross_device(dev):
    """The same small bag on the card and on the CPU: statuses equal,
    iterations within ±1, x within rtol=1e-4, atol=1e-6."""
    import numpy as np
    from repro_torch.core.batch import jpcg_solve_batched
    from repro_torch.sparse import diag_dominant_spd, poisson_2d, powerlaw_spd
    bag = [poisson_2d(12), diag_dominant_spd(150, nnz_per_row=6,
                                              dominance=1.4, seed=5),
           powerlaw_spd(300, alpha=2.1, seed=5)]
    for backend in ("xla", "pallas"):
        for scheme in SCHEMES:
            kw = dict(tol=SOLVE_TOL, scheme=scheme, backend=backend,
                      block_rows=128, col_tile=128)
            gpu = jpcg_solve_batched(bag, device=dev, **kw)
            cpu = jpcg_solve_batched(bag, device="cpu", **kw)
            for g, (a, b) in enumerate(zip(gpu, cpu)):
                if (a.status != b.status
                        or abs(a.iterations - b.iterations) > 1):
                    raise AssertionError(
                        f"{backend}/{scheme} lane {g}: card {a.status}/"
                        f"{a.iterations} vs cpu {b.status}/{b.iterations}")
                np.testing.assert_allclose(a.x.cpu().numpy(), b.x.numpy(),
                                           rtol=1e-4, atol=1e-6)
    log("  card ≡ cpu within tolerance for 4 schemes × {SELL, ELLPACK}")


# -------------------------------------------------------------- phase 5
SINGLE_NX = 1000                    # poisson_2d(1000): n = 10^6
RAGGED_N = (1, 4095, 4097, 1_000_003)   # 1,000,003 is prime


def cold_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of one call of ``fn`` with a cold L2.  Before each
    call a 1 GiB read evicts the 50 MB L2 and leaves it clean (a write
    would leave it dirty, and the call would pay for the write-back); a
    pair of events brackets the call alone.  The read (~0.3 ms) outlasts
    the host's work of issuing the call, so the events time the device,
    not the host."""
    import torch
    flush = torch.zeros(256 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warm):
        fn()
    marks = []
    for _ in range(reps):
        flush.sum()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / reps


def _held(label, got, want, errs, name):
    """Kernel output ≡ plain output, bitwise; records max |Δ|."""
    import torch
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.cuda.synchronize()
        err = float((g.double() - w.double()).abs().max()) if g.numel() \
            else 0.0
        errs[name] = max(errs.get(name, 0.0), err)
        if not _same(g, w):
            raise AssertionError(f"{label}: {name} differs from its plain "
                                 f"version (max |Δ| {err})")


def phase_single_kernels(a, dev):
    """spmv_ell, dot, dot3, phase2, phase3 against their plain versions on
    the card, bitwise; each timed at n = 10^6 with its bound."""
    import torch
    from repro_torch.core.precision import get_scheme
    from repro_torch.kernels import dot as D
    from repro_torch.kernels import fused_phase as F
    from repro_torch.kernels import spmv as K
    from repro_torch.sparse import csr_to_ellpack

    gen = torch.Generator(device="cpu").manual_seed(12)
    errs, timed = {}, {}
    n = a.shape[0]
    t0 = time.perf_counter()
    m = csr_to_ellpack(a)
    log(f"  ELLPACK pack of n={n}: {time.perf_counter() - t0:.2f} s, "
        f"B={m.n_row_blocks} T={m.n_slabs} E={m.ell} R={m.block_rows}, "
        f"{m.vals.size} stored slots for {a.nnz} nonzeros")
    tc = torch.from_numpy(m.tile_cols).to(dev)
    lc = torch.from_numpy(m.local_cols).to(dev)
    xt = torch.randn(m.padded_cols, generator=gen, dtype=torch.float64
                     ).reshape(-1, m.col_tile).to(dev)
    for name in SCHEMES:
        sch = get_scheme(name)
        v = torch.from_numpy(m.vals).to(dev, sch.matrix_dtype)
        args = (tc, v, lc, xt)
        y_k = K.spmv_ell(*args, scheme=sch)
        _held(f"spmv_ell/{name}", y_k, K.spmv_ell_plain(*args, scheme=sch),
              errs, "spmv_ell")
        log(f"  spmv_ell {name:8s}: bitwise equal")
        if name != "mixed_v3":
            continue
        in_el = torch.empty((), dtype=sch.spmv_in_dtype).element_size()
        acc_el = y_k.element_size()
        need = a.nnz * (v.element_size() + lc.element_size()) \
            + n * (in_el + acc_el)
        b_ms, b_by = bound_ms(need, 2 * a.nnz, sch.spmv_acc_dtype)
        moved = nbytes(tc, v, lc) + xt.numel() * in_el + nbytes(y_k)
        st_ms, _ = bound_ms(moved, 2 * v.numel(), sch.spmv_acc_dtype)
        A = block_diag_csr([a], n, dev, torch.float64)
        xs = xt.reshape(-1)[:n].reshape(-1, 1).contiguous()
        timed["spmv_ell"] = dict(
            ms=cold_ms(lambda: K.spmv_ell(*args, scheme=sch)),
            plain_ms=cold_ms(lambda: K.spmv_ell_plain(*args, scheme=sch)),
            library_ms=cold_ms(lambda: torch.sparse.mm(A, xs)),
            bound_ms=b_ms, bound_by=b_by, bound_stored_ms=st_ms,
            library_dtype="float64", bytes=need, stored_bytes=moved)
        del A

    for dt in (torch.float64, torch.float32):
        for nn in (n,) + RAGGED_N:
            r, ap, p, x, w = (torch.randn(nn, generator=gen, dtype=dt
                                          ).to(dev) for _ in range(5))
            dg = (torch.rand(nn, generator=gen, dtype=dt) + 0.5).to(dev)
            alpha = torch.tensor(0.37, dtype=dt, device=dev)
            beta = torch.tensor(0.71, dtype=dt, device=dev)
            label = f"{str(dt)[6:]}/n={nn}"
            _held(label, D.dot(p, ap), D.dot_plain(p, ap), errs, "dot")
            _held(label, D.dot3(r, p, w), D.dot3_plain(r, p, w), errs,
                  "dot3")
            _held(label, F.phase2(alpha, r, ap, dg),
                  F.phase2_plain(alpha, r, ap, dg), errs, "phase2")
            _held(label, F.phase3(alpha, beta, r, dg, p, x),
                  F.phase3_plain(alpha, beta, r, dg, p, x), errs, "phase3")
            log(f"  dot dot3 phase2 phase3 {label}: bitwise equal")
            if dt != torch.float64 or nn != n:
                continue
            el = r.element_size()
            cases = {
                # name: (kernel, plain, library, vectors read + written,
                #        flops per element)
                "dot": (lambda: D.dot(p, ap), lambda: D.dot_plain(p, ap),
                        lambda: torch.dot(p, ap), 2, 2),
                "dot3": (lambda: D.dot3(r, p, w),
                         lambda: D.dot3_plain(r, p, w), None, 3, 6),
                "phase2": (lambda: F.phase2(alpha, r, ap, dg),
                           lambda: F.phase2_plain(alpha, r, ap, dg), None,
                           4, 7),
                "phase3": (lambda: F.phase3(alpha, beta, r, dg, p, x),
                           lambda: F.phase3_plain(alpha, beta, r, dg, p,
                                                  x), None, 6, 5),
            }
            for name, (kern, plain, lib, vecs, fl) in cases.items():
                b_ms, b_by = bound_ms(vecs * nn * el, fl * nn, dt)
                timed[name] = dict(
                    ms=cold_ms(kern), plain_ms=cold_ms(plain),
                    library_ms=None if lib is None else cold_ms(lib),
                    bound_ms=b_ms, bound_by=b_by, bytes=vecs * nn * el)
    for name, t in timed.items():
        t["max_abs_err"] = errs[name]
        lib = ("–" if t["library_ms"] is None
               else f"{t['library_ms']:.4f}")
        extra = (f"; stored-slot bound {t['bound_stored_ms']:.4f} ms "
                 f"({t['stored_bytes']} B, {t['bound_stored_ms'] / t['ms']:.1%})"
                 if "bound_stored_ms" in t else "")
        log(f"    {name}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, "
            f"library {lib}); bound {t['bound_ms']:.4f} ms by "
            f"{t['bound_by']} ({t['bytes']} B, "
            f"{t['bytes'] / t['ms'] / 1e6:.1f} GB/s, "
            f"{t['bound_ms'] / t['ms']:.1%}){extra}")
    return timed


# -------------------------------------------------------------- phase 6
SINGLE_RUNS = (("vsr", "pallas", "mixed_v3"), ("vsr", "pallas", "fp64"),
               ("vsr", "xla", "mixed_v3"), ("pipelined", "xla", "mixed_v3"))


def _single(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_single_solve(a, dev) -> dict:
    """``jpcg_solve`` at full size on every requested method, backend and
    scheme; returns the launches of the calls from the CSR."""
    import numpy as np
    import torch
    from repro_torch import jpcg_solve
    from repro_torch.core.operators import as_operator
    from repro_torch.kernels import ops

    launches = {}
    out = {}
    for method, backend, scheme in SINGLE_RUNS:
        kw = dict(method=method, backend=backend, scheme=scheme,
                  tol=SOLVE_TOL, maxiter=20_000, device=dev)
        ops.reset_launches()
        res, call_s = _single(lambda: jpcg_solve(a, **kw))
        counts = ops.launches()
        its = res.iterations
        res_true = residual(a, res.x)
        if not res.converged or res_true > RESIDUAL_MAX:
            raise AssertionError(f"{method}/{backend}/{scheme}: converged "
                                 f"{res.converged} after {its}, true "
                                 f"residual {res_true:.3e}")
        if backend == "pallas":
            # one SpMV per iteration plus init_state's, one dot, phase 2
            # and phase 3 per iteration: no plain version on this path
            want = dict.fromkeys(counts, 0)
            want.update(spmv_ell=its + 1, dot=its, phase2=its, phase3=its)
        else:
            want = dict.fromkeys(counts, 0)
        if counts != want:
            raise AssertionError(f"{method}/{backend}/{scheme}: launches "
                                 f"{counts}, expected {want}")
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
        t0 = time.perf_counter()
        op = (ops.ell_operator_pallas(a, scheme, device=dev)
              if backend == "pallas" else as_operator(a, scheme, device=dev))
        pack_s = time.perf_counter() - t0
        loop, loop_s = _single(lambda: jpcg_solve(op, **kw))
        # every path is deterministic: the same solve again is the same
        # solve, bit for bit
        if loop.iterations != its or not torch.equal(loop.x, res.x):
            raise AssertionError(f"{method}/{backend}/{scheme}: loop alone "
                                 f"took {loop.iterations}, the call {its}; "
                                 f"x equal {torch.equal(loop.x, res.x)}")
        out[(method, backend, scheme)] = res
        log(f"  {method}/{backend}/{scheme}: {its} iterations, call "
            f"{call_s:.3f} s ({call_s / its * 1e3:.3f} ms/iteration); "
            f"operator build {pack_s:.3f} s; loop alone {loop_s:.3f} s = "
            f"{loop_s / its * 1e3:.4f} ms/iteration; true residual "
            f"{res_true:.2e}")
        if (method, backend, scheme) == SINGLE_RUNS[0]:
            _, wall, ev = device_profile(lambda: jpcg_solve(op, **kw))
            busy_ms = sum(t for _, t, _ in ev)
            n_k = sum(c for _, _, c in ev)
            log(f"    profile: {n_k} kernels ({n_k / its:.1f}/iteration), "
                f"device busy {busy_ms:.1f} ms = {busy_ms / its:.4f} "
                f"ms/iteration = {busy_ms / 1e3 / loop_s:.1%} of the "
                f"unprofiled loop ({loop_s:.3f} s; {wall:.3f} s profiled)")
            for key, t, c in sorted(ev, key=lambda e: -e[1])[:8]:
                log(f"      {t:9.1f} ms {c:7d}x {t / c * 1e3:8.1f} µs  "
                    f"{key[:80]}")
    kp = out[("vsr", "pallas", "mixed_v3")]
    kx = out[("vsr", "xla", "mixed_v3")]
    pp = out[("pipelined", "xla", "mixed_v3")]
    if abs(kp.iterations - kx.iterations) > 1:
        raise AssertionError(f"vsr mixed_v3: pallas {kp.iterations} vs "
                             f"xla {kx.iterations} iterations")
    for label, r in (("vsr/xla", kx), ("pipelined/xla", pp)):
        np.testing.assert_allclose(r.x.cpu().numpy(), kp.x.cpu().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=label)
    log("  mixed_v3: vsr pallas ≡ xla (iterations ±1, x within rtol 1e-4, "
        "atol 1e-6); pipelined x within the same tolerance")
    return launches


# ------------------------------------------------------------------ main
def main() -> int:
    if len(sys.argv) > 1:
        print("chip_smoke: takes no arguments", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops
    from repro_torch.sparse import poisson_2d

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s into {_build.build_dir()}")
    for name in ("spmv_sell", "spmv_ellpack", "dot", "fused_phase"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    bag = smoke_bag()
    log(f"[data] bag G={len(bag)} n={[a.shape[0] for a in bag]}"
        f" nnz={[a.nnz for a in bag]} in {time.perf_counter() - t0:.1f} s")

    # the kernels each path must launch
    paths = {"solve": ("spmv_sell", "spmv_ellpack"),
             "engine": ("spmv_sell", "spmv_ellpack"),
             "single": ("spmv_ell", "dot", "phase2", "phase3")}
    launches = {}
    log("[phase 1] kernels against their plain versions")
    timed = phase_kernels(bag, dev)
    log("[phase 2] batched solve")
    ops.reset_launches()
    phase_solve(bag, dev)
    launches["solve"] = ops.launches()
    log(f"  launches {launches['solve']}")
    log("[phase 3] SolverEngine")
    ops.reset_launches()
    phase_engine(bag, dev)
    launches["engine"] = ops.launches()
    log(f"  launches {launches['engine']}")
    log("[phase 4] card against CPU")
    phase_cross_device(dev)

    t0 = time.perf_counter()
    single = poisson_2d(SINGLE_NX)
    log(f"[data] poisson_2d({SINGLE_NX}): n={single.shape[0]} "
        f"nnz={single.nnz} in {time.perf_counter() - t0:.1f} s")
    log("[phase 5] single-system kernels against their plain versions")
    timed.update(phase_single_kernels(single, dev))
    log("[phase 6] single-system solve")
    launches["single"] = phase_single_solve(single, dev)
    log(f"  launches {launches['single']}")
    for path, names in paths.items():
        for name in names:
            if launches[path][name] <= 0:
                raise AssertionError(f"{name} never launched on the {path} "
                                     "path")

    sources = {"spmv_sell": "spmv_sell.cu", "spmv_ellpack": "spmv_ellpack.cu",
               "spmv_ell": "spmv_ellpack.cu", "dot": "dot.cu",
               "dot3": "dot.cu", "phase2": "fused_phase.cu",
               "phase3": "fused_phase.cu"}
    replaces = {"spmv_sell": "src/repro/kernels/spmv.py:179",
                "spmv_ellpack": "src/repro/kernels/spmv.py:123",
                "spmv_ell": "src/repro/kernels/spmv.py:68",
                "dot": "src/repro/kernels/dot.py:60",
                "dot3": "src/repro/kernels/dot.py:106",
                "phase2": "src/repro/kernels/fused_phase.py:62",
                "phase3": "src/repro/kernels/fused_phase.py:106"}
    kernels = []
    for name, src in sources.items():
        t = timed[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces[name],
            "launches": sum(c.get(name, 0) for c in launches.values()),
            **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            **{k: t[k] for k in ("bound_stored_ms", "library_dtype")
               if k in t}})
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
