"""Batched multi-system JPCG — the torch port of :mod:`repro.core.batch`.

G independent SPD systems are stacked along a leading lane axis and
solved in one masked loop through one of two engines:

* ``engine="vm"`` (default) — the batched stream VM
  (:mod:`repro_torch.core.vm`) running the canonical compiled program
  (or ``program=``), specialized into its runner or, with
  ``specialize=False``, as an operand of one runner per bucket;
* ``engine="phases"`` — :func:`repro_torch.core.phases.vsr_iteration`
  on ``[G, n]`` lanes, the oracle the VM is held to bitwise.

Every lane carries its own ``active`` flag and terminates on the fly at
its own ``‖r‖² ≤ τ_g``; a frozen lane still flows through the arithmetic
but every state write is a ``torch.where`` select on the lane's commit
mask, never a blend.  The loop runs eagerly: each tick is a handful of
kernels on the current stream, and the host reads the termination
predicate once per ``steps_per_sync`` ticks — the only host sync of the
loop.  Ticks self-gate on ``any(active) & (k < bound)`` as device tensors,
so any chunk size gives bit-identical results.

The M1 SpMV dispatch (:func:`_matvec_factory`) sends every layout through
a hand-written CUDA kernel for CUDA tensors (row-ELL and SELL through
:func:`repro_torch.kernels.spmv.spmv_sell`, ELLPACK through
:func:`~repro_torch.kernels.spmv.spmv_ellpack`) and through their plain
PyTorch versions for CPU tensors.  ``backend="xla"|"pallas"`` keeps its
reference meaning: the default layout (row-ELL | ELLPACK) and the cache
keys.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cg import CGResult
from repro_torch.core.metrics import (advance_status, finalize_status,
                                      initial_status, is_breakdown,
                                      solver_metrics, status_name,
                                      tick_health)
from repro_torch.core.phases import vsr_iteration
from repro_torch.core.precision import (PrecisionScheme, get_scheme,
                                        host_values, values_tensor)
from repro_torch.core.shard import (Shards, lane_mesh, mesh_shards,
                                    pad_lanes, place_lanes, shard_any)
from repro_torch.device import resolve_device
from repro_torch.kernels.spmv import sell_table, spmv_ellpack, spmv_sell
from repro_torch.sparse.csr import CSRMatrix, csr_from_coo
from repro_torch.sparse.ellpack import csr_to_ellpack
from repro_torch.sparse.stacking import (choose_layout, stack_ellpack,
                                         stack_rowell, stack_sell)

__all__ = ["BatchedCGState", "jpcg_solve_batched", "batched_matvec_rowell",
           "batched_matvec_sell", "batched_matvec_ellpack",
           "batched_matvec_flat", "tree_sum",
           "rounded_products", "stack_operands", "batch_cache_info",
           "batch_cache_clear"]


class BatchedCGState(NamedTuple):
    """Per-lane CG state of the phases engine, leading axis = lane."""

    k: torch.Tensor        # global loop counter (int32 scalar)
    it: torch.Tensor       # int32[G] per-lane iteration counts
    status: torch.Tensor   # int32[G] exit codes (metrics.STATUS_*)
    x: torch.Tensor        # [G, n] solutions (frozen once a lane is done)
    r: torch.Tensor        # [G, n] residuals
    p: torch.Tensor        # [G, n] search directions
    rz: torch.Tensor       # [G]
    rr: torch.Tensor       # [G] per-lane ‖r‖² — the termination scalars
    active: torch.Tensor   # bool[G] live-lane mask
    trace: torch.Tensor    # [G, maxiter] rr per iteration, or [G, 0]


#: Stage widths of :func:`_row_dot`: a long row's first stage sums
#: sub-rows of ``_DOT_WIDE``; every other stage sums ``_DOT_NARROW``.
_DOT_WIDE, _DOT_NARROW = 8192, 32


def _row_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot of ``[G, n]`` tensors — the one dot of the batch
    runner, the VM and the serving warm-up — whose bits for a row do not
    depend on G.

    CUDA's ``sum`` over the last dim picks its threads a row, and for
    long rows a split of each row over blocks, from the row length and
    the number of rows, so ``(a*b).sum(-1)`` gives a row other bits
    beside other lanes (a lane shard, a compacted pool).  Here every
    stage sums rows of a width fixed by n alone, each short enough that
    no block shape splits it over blocks:

    * a row of n ≥ 16·8,192 first sums sub-rows of 8,192 (≥ 16 of them a
      lane, so the block shape is the same for any G);
    * then rows of 32 (one warp a row, one value a thread: no G changes
      that), zero-padded, until ≤ 32 partials a lane are left;
    * then those partials (≤ 32 wide: one thread a partial or two).

    The card check is ``chip_smoke.py``'s phase 6b, at n up to 8.4 M and
    G ∈ {1, 2, 4, 8}."""
    G, n = a.shape
    w = _DOT_WIDE if n >= 16 * _DOT_WIDE else _DOT_NARROW
    if n > _DOT_NARROW and n % w:
        p = a.new_zeros((G, n + -n % w), dtype=torch.result_type(a, b))
        torch.mul(a, b, out=p[:, :n])
    else:
        p = a * b
    while p.shape[1] > _DOT_NARROW:
        m = p.shape[1]
        if m % w:
            p = torch.nn.functional.pad(p, (0, -m % w))
        p = p.reshape(-1, w).sum(-1).reshape(G, -1)
        w = _DOT_NARROW
    return p.sum(-1)


# ------------------------------------------------------------ numerics
def tree_sum(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Deterministic halving-tree reduction over ``dim``.

    Pads to a power of two with exact zeros, then repeatedly adds the top
    half onto the bottom half.  The bracketing is suffix-stable (an
    all-zero top half folds away exactly), so a row reduced at any padded
    width ≥ its nonzero count gives identical bits — what makes row-ELL,
    sliced-ELL and the CUDA kernels bit-interchangeable.
    """
    dim = dim % p.dim()
    w = p.shape[dim]
    wp = 1 << max(w - 1, 0).bit_length()
    if wp != w:
        pad = list(p.shape)
        pad[dim] = wp - w
        p = torch.cat([p, p.new_zeros(pad)], dim=dim)
    while wp > 1:
        h = wp // 2
        p = p.narrow(dim, 0, h) + p.narrow(dim, h, h)
        wp = h
    return p.select(dim, 0)


def rounded_products(vals: torch.Tensor, xg: torch.Tensor,
                     acc: torch.dtype) -> torch.Tensor:
    """``vals ⊙ xg`` at ``acc``, correctly rounded, plus ``xg·0``.

    Eager torch rounds every product; the added ``xg·0`` (±0, or NaN
    where ``xg`` is not finite) reproduces the reference's
    ``v*g + g*0`` bits, signs of zero included, and is what the CUDA
    kernel computes per slot."""
    v = vals.to(acc)
    g = xg.to(acc)
    return v * g + g * 0.0


# --------------------------------------------------------------- matvecs
def batched_matvec_rowell(cols, vals, x, *,
                          scheme: PrecisionScheme) -> torch.Tensor:
    """Batched SpMV over slot-major row-ELL lanes ``[G, W, n_pad]`` — the
    one-group case of the SELL kernel."""
    G, W, n_pad = cols.shape
    y = spmv_sell(cols.reshape(G, W * n_pad), vals.reshape(G, W * n_pad), x,
                  groups=((n_pad, W),), scheme=scheme)
    return y.to(scheme.vector_dtype)


def batched_matvec_sell(cols, vals, iperm, x, *, groups,
                        scheme: PrecisionScheme, table=None) -> torch.Tensor:
    """Batched SpMV over stacked SELL-C-σ lanes: the kernel's sorted-order
    result un-permuted by ``iperm`` (int64 ``[G, n_pad]``) and cast to
    ``vector_dtype``; ``table`` the operand's
    :class:`~repro_torch.kernels.spmv.SellTable` (each lane read at its
    own widths).  Equal to :func:`batched_matvec_rowell` on the same
    matrix up to the sign of an all-zero row sum."""
    y_sorted = spmv_sell(cols, vals, x, groups=groups, scheme=scheme,
                         table=table)
    return torch.gather(y_sorted, 1, iperm).to(scheme.vector_dtype)


def batched_matvec_flat(gcols, vals, rows, x, *, n_rows: int,
                        padded_cols: int,
                        scheme: PrecisionScheme) -> torch.Tensor:
    """Batched SpMV over packed nonzero streams, plain PyTorch.

    ``gcols``/``vals``/``rows`` are the ``[G, N]`` stacked streams of
    :func:`repro_torch.sparse.stacking.stack_flat` as tensors; ``x`` is
    ``[G, n]``.  Gathers x per nonzero, multiplies at the scheme's
    accumulate dtype and sums into rows with ``index_put_(accumulate=
    True)`` (a fixed order on every device).  The reference keeps it as
    the stream-layout reference implementation; no solver path of
    either package calls it, and it has no kernel."""
    acc = scheme.spmv_acc_dtype
    G = x.shape[0]
    k = min(x.shape[-1], padded_cols)
    x_pad = x.new_zeros((G, padded_cols), dtype=scheme.spmv_in_dtype)
    x_pad[:, :k] = x[:, :k]
    xg = torch.gather(x_pad, 1, gcols.long())
    prod = vals.to(acc) * xg.to(acc)
    lane = torch.arange(G, device=x.device)[:, None].expand_as(prod)
    y = torch.zeros((G, n_rows), dtype=acc, device=x.device)
    y.index_put_((lane, rows.long()), prod, accumulate=True)
    return y.to(scheme.vector_dtype)


def batched_matvec_ellpack(tile_cols, vals, local_cols, x, *, col_tile: int,
                           n_col_tiles: int,
                           scheme: PrecisionScheme) -> torch.Tensor:
    """Batched banked-ELLPACK SpMV: x padded into ``[G, n_col_tiles,
    col_tile]`` tiles, one kernel launch for all G lanes."""
    G, n = x.shape
    padded_cols = n_col_tiles * col_tile
    k = min(n, padded_cols)
    x_pad = x.new_zeros((G, padded_cols))
    x_pad[:, :k] = x[:, :k]
    y = spmv_ellpack(tile_cols, vals, local_cols,
                     x_pad.reshape(G, n_col_tiles, col_tile), scheme=scheme)
    return y.reshape(G, -1)[:, :n].to(scheme.vector_dtype)


def _matvec_factory(*, backend, scheme, layout=None, groups=None,
                    block_rows=None, col_tile=None, n_col_tiles=None):
    """``matvec_of(mat) -> matvec`` closure for one backend + bucket shape,
    shared by the solve runners, the serving stepper and the serving
    warm-up so every path computes the same M1.  ``layout``: ``"rowell"``
    (``mat = (cols, vals)``), ``"sell"`` (``(cols, vals, iperm, table)``
    with static ``groups``; ``table`` the
    :class:`~repro_torch.kernels.spmv.SellTable`) or ``"ellpack"``
    (``(tile_cols, vals, local_cols)``).  The operands carry their own
    shapes: ``block_rows``, where given, must equal an ELLPACK operand's
    tile rows (``vals.shape[-1]``, the kernel's block) or the matvec
    raises; row-ELL and SELL operands have no row tiles, and there it is
    ignored, as the reference ignores it."""
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    layout = layout or ("rowell" if backend == "xla" else "ellpack")
    if layout == "sell":
        if groups is None:
            raise ValueError("layout='sell' needs the static groups= "
                             "signature of the stacked operand")

        def matvec_of(mat):
            cols, vals, iperm, table = mat
            return lambda x: batched_matvec_sell(cols, vals, iperm, x,
                                                 groups=groups, scheme=scheme,
                                                 table=table)
    elif backend == "xla" and layout == "rowell":
        def matvec_of(mat):
            cols, vals = mat
            return lambda x: batched_matvec_rowell(cols, vals, x,
                                                   scheme=scheme)
    elif backend == "pallas" and layout == "ellpack":
        def matvec_of(mat):
            tc, v, lc = mat
            if block_rows is not None and int(v.shape[-1]) != block_rows:
                raise ValueError(
                    f"block_rows={block_rows} disagrees with the packed "
                    f"ELLPACK operand's tile rows ({int(v.shape[-1])}): the "
                    "kernel takes its block from the operand, so pack with "
                    "this block_rows or drop the argument")
            return lambda x: batched_matvec_ellpack(
                tc, v, lc, x, col_tile=col_tile, n_col_tiles=n_col_tiles,
                scheme=scheme)
    else:
        raise ValueError(f"unsupported backend/layout combination "
                         f"{backend!r}/{layout!r}")
    return matvec_of


# ------------------------------------------------------- loop construction
def _masked_trace(trace, k, keep, rr_new):
    """Record ``rr`` at column ``k`` for committed lanes, in place; no-op
    once ``k`` is past the trace width."""
    width = trace.shape[1]
    if not width:
        return trace
    col = torch.clamp(k, max=width - 1).long().reshape(1, 1)
    col = col.expand(trace.shape[0], 1)
    ok = (keep & (k < width))[:, None]
    old = trace.gather(1, col)
    trace.scatter_(1, col, torch.where(ok, rr_new[:, None], old))
    return trace


def _batched_init(matvec, diag, b, x0, *, maxiter, with_trace, tol,
                  detect=True):
    G = b.shape[0]
    r = b - matvec(x0)
    z = r / diag
    rz = _row_dot(r, z)
    rr = _row_dot(r, r)
    dev = b.device
    return BatchedCGState(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        it=torch.zeros(G, dtype=torch.int32, device=dev),
        status=initial_status(rr, tol, detect=detect),
        x=x0, r=r, p=z, rz=rz, rr=rr, active=rr > tol,
        trace=torch.zeros((G, maxiter if with_trace else 0), dtype=b.dtype,
                          device=dev))


def _batched_body(matvec, diag, tol, maxiter_vec=None, *, bound=None,
                  detect=True):
    """Masked VSR iteration over all lanes (the phases engine's tick).

    ``bound`` makes the tick self-gating: once every lane is done or
    ``k`` reached ``bound`` it writes nothing and does not advance ``k``
    — the predicate the host checks once per chunk, evaluated per tick.
    ``detect`` arms :func:`~repro_torch.core.metrics.tick_health`: a lane
    that trips it freezes this tick and latches its breakdown status.
    """

    def body(s: BatchedCGState) -> BatchedCGState:
        x_new, r_new, p_new, rz_new, rr_new, (pap, alpha, beta) = \
            vsr_iteration(matvec, diag, s.x, s.r, s.p, s.rz, dot=_row_dot,
                          with_aux=True)
        go = s.active.any()
        if bound is not None:
            go = go & (s.k < bound)
        keep = s.active & go
        upd, bd_i, bd_n = tick_health(keep, pap, alpha, beta, rr_new,
                                      detect=detect)
        kv = upd[:, None]
        x = torch.where(kv, x_new, s.x)
        r = torch.where(kv, r_new, s.r)
        p = torch.where(kv, p_new, s.p)
        rz = torch.where(upd, rz_new, s.rz)
        rr = torch.where(upd, rr_new, s.rr)
        it = s.it + upd.to(torch.int32)
        trace = _masked_trace(s.trace, s.k, upd, rr_new)
        live = rr > tol
        if maxiter_vec is not None:
            live = live & (it < maxiter_vec)
        if detect:
            live = live & ~(bd_i | bd_n)
        status = advance_status(s.status, upd=upd, bd_indef=bd_i,
                                bd_nonf=bd_n, rr_new=rr_new, tol=tol,
                                it=it, maxiter_vec=maxiter_vec)
        # a no-op tick (go=False) must not re-evaluate liveness
        active = torch.where(keep, live, s.active)
        return BatchedCGState(k=s.k + go.to(torch.int32), it=it,
                              status=status, x=x, r=r, p=p, rz=rz, rr=rr,
                              active=active, trace=trace)

    return body


def _run_chunked(conds, ticks, states, *, steps: int):
    """Drive each lane shard's tick until no shard's ``cond`` holds (one
    shard when unsharded), reading the predicate on the host once per
    ``steps`` ticks: ``any`` over every shard, gathered on the first
    shard's device.  Ticks self-gate, so trailing ticks of the last chunk
    are no-ops and results equal ``steps=1`` bit for bit.

    A shard's tick gates on its own lanes, so a shard whose lanes are all
    done stops advancing ``k``; after each chunk every shard's ``k`` is set
    to the largest, the count the unsharded loop reaches (lanes never
    restart within a call, so a shard with a live lane has taken every
    tick the loop took).  ``k``, and the trace column it indexes, stay
    the unsharded ones."""
    steps = max(1, int(steps))
    states = list(states)
    while shard_any(c(s) for c, s in zip(conds, states)):
        for _ in range(steps):
            states = [tick(s) for tick, s in zip(ticks, states)]
        if len(states) > 1:
            home = states[0].k.device
            k = torch.stack([s.k.to(home) for s in states]).amax()
            for s in states:
                s.k.copy_(k)
    return states


def _shard_args(mesh, args):
    """Per-shard argument tuples: ``args`` themselves when unsharded, else
    the shards of each (:func:`repro_torch.core.shard.place_lanes`'s
    :class:`~repro_torch.core.shard.Shards`; sharded runners and steppers
    never place, so they keep no device)."""
    if mesh is None:
        return [tuple(args)]
    d = mesh_shards(mesh)
    for a in args:
        if not (isinstance(a, Shards) and len(a) == d):
            raise TypeError(f"a runner over {d} lane shards takes operands "
                            "laid out by core.shard.place_lanes / "
                            f"place_vm_state, got {type(a).__name__}")
    return list(zip(*args))


def _unshard(mesh, states):
    """The runner's result: one state unsharded, else a ``Shards``."""
    return states[0] if mesh is None else Shards(states)


# ------------------------------------------------------------------ cache
_CACHE: dict = {}
_CACHE_STATS = {"hits": 0, "misses": 0}


def batch_cache_info() -> dict:
    """Runner-cache statistics: {entries, hits, misses}."""
    return {"entries": len(_CACHE), **_CACHE_STATS}


def batch_cache_clear() -> None:
    _CACHE.clear()
    _CACHE_STATS.update(hits=0, misses=0)


def _cached(key, make):
    fn = _CACHE.get(key)
    if fn is None:
        _CACHE_STATS["misses"] += 1
        fn = _CACHE[key] = make()
    else:
        _CACHE_STATS["hits"] += 1
    return fn


def _make_runner(*, backend, scheme, maxiter, with_trace, layout=None,
                 groups=None, col_tile=None, n_col_tiles=None,
                 steps_per_sync=8, detect=True, mesh=None):
    """The phases engine's solve-to-completion runner for one bucket:
    ``run(mat, diag, b, x0, tol) -> BatchedCGState``; leftover ``RUNNING``
    statuses finalize to ``MAXITER``.  With a ``mesh`` every argument is
    the :class:`~repro_torch.core.shard.Shards` that
    :func:`~repro_torch.core.shard.place_lanes` lays out, and so is the
    result (one state per lane shard)."""
    matvec_of = _matvec_factory(backend=backend, scheme=scheme,
                                layout=layout, groups=groups,
                                col_tile=col_tile, n_col_tiles=n_col_tiles)

    def cond(s):
        return (s.k < maxiter) & s.active.any()

    def run(mat, diag, b, x0, tol):
        states, ticks = [], []
        for m, d, b_s, x_s, t in _shard_args(mesh, (mat, diag, b, x0, tol)):
            matvec = matvec_of(m)
            states.append(_batched_init(matvec, d, b_s, x_s, maxiter=maxiter,
                                        with_trace=with_trace, tol=t,
                                        detect=detect))
            ticks.append(_batched_body(matvec, d, t, bound=maxiter,
                                       detect=detect))
        out = _run_chunked([cond] * len(states), ticks, states,
                           steps=steps_per_sync)
        return _unshard(mesh, [o._replace(status=finalize_status(o.status))
                               for o in out])

    return run


# ---------------------------------------------------------------- public
def _as_csr(a) -> CSRMatrix:
    if isinstance(a, CSRMatrix):
        return a
    arr = np.asarray(a)
    if arr.ndim == 2 and arr.shape[0] == arr.shape[1]:
        rows, cols = np.nonzero(arr)
        return csr_from_coo(rows, cols, arr[rows, cols], arr.shape)
    raise TypeError(f"cannot batch-solve a {type(a)}")


def _pad_stack(vecs: Sequence[np.ndarray], n_pad: int, fill: float, dtype,
               device) -> torch.Tensor:
    out = np.full((len(vecs), n_pad), fill, dtype=np.float64)
    for g, v in enumerate(vecs):
        out[g, : v.shape[0]] = np.asarray(v, dtype=np.float64)
    return torch.from_numpy(out).to(device=device, dtype=dtype)


def stack_operands(csrs: Sequence[CSRMatrix], *, backend: str, layout: str,
                   scheme: PrecisionScheme, device, bucket: bool = True,
                   block_rows: int = 256, col_tile: int = 512):
    """Pack a bag into one layout's device operands.

    Returns ``(mat, stacked, groups, n_col_tiles, bucket_dims)``: ``mat``
    the tensors the matvec consumes (values at ``scheme.matrix_dtype``,
    bf16 through its bits; SELL ``iperm`` as int64 for ``torch.gather``,
    then the per-lane :class:`~repro_torch.kernels.spmv.SellTable` built
    from the lane widths), ``stacked`` the host stacker's result."""
    def dev(a, dtype=None):
        return values_tensor(a, device, dtype)

    def vals(a):
        return values_tensor(host_values(a, scheme.host_matrix_dtype),
                             device, scheme.matrix_dtype)

    if layout == "sell":
        stacked = stack_sell(csrs, bucket=bucket, scheme=scheme)
        mat = (dev(stacked.cols), vals(stacked.vals),
               dev(stacked.iperm, torch.int64),
               sell_table(stacked.groups, device=device,
                          lane_widths=stacked.lane_widths,
                          slice_rows=stacked.slice_rows))
        return (mat, stacked, stacked.groups, None,
                (stacked.padded_rows,
                 *(d for rw in stacked.groups for d in rw)))
    if backend == "xla" and layout == "rowell":
        stacked = stack_rowell(csrs, bucket=bucket, scheme=scheme)
        mat = (dev(stacked.cols), vals(stacked.vals))
        return mat, stacked, None, None, (stacked.padded_rows, stacked.width)
    if backend == "pallas" and layout == "ellpack":
        stacked = stack_ellpack(
            [csr_to_ellpack(a, block_rows=block_rows, col_tile=col_tile)
             for a in csrs], bucket=bucket)
        mat = (dev(stacked.tile_cols), vals(stacked.vals),
               dev(stacked.local_cols))
        return (mat, stacked, None, stacked.n_col_tiles,
                (*stacked.vals.shape[1:], stacked.n_col_tiles))
    raise ValueError(f"unsupported backend/layout combination "
                     f"{backend!r}/{layout!r}")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def jpcg_solve_batched(problems: Sequence, bs: Optional[Sequence] = None,
                       x0s: Optional[Sequence] = None, *,
                       tol=1e-12, maxiter: int = 20_000,
                       scheme="mixed_v3", backend: str = "xla",
                       engine: str = "vm", policy: Optional[str] = None,
                       program: Optional[np.ndarray] = None,
                       specialize: bool = True,
                       block_rows: int = 256, col_tile: int = 512,
                       bucket: bool = True, layout: str = "auto",
                       with_trace: bool = False,
                       steps_per_sync: int = 8, detect: bool = True,
                       with_status: bool = True, interpret=None, mesh=None,
                       device=None) -> List[CGResult]:
    """Solve G independent SPD systems in one masked loop on ``device``
    (default ``"cuda"``; pass ``device="cpu"`` for the plain path).

    Same knobs and results as :func:`repro.core.batch.jpcg_solve_batched`
    (``engine``, ``policy``/``program``, ``specialize``, ``layout``,
    ``steps_per_sync``, ``detect``, ``with_status``, ``with_trace``,
    ``mesh``); ``x`` in each result is a tensor on its lane's device.
    ``specialize=False`` runs the program as an operand of one runner
    cached per bucket (:func:`repro_torch.core.vm.make_vm_runner` with
    ``program=None``), bitwise equal to the specialized runner.

    ``mesh`` (a tuple of devices, :func:`repro_torch.core.shard.lane_mesh`;
    it takes the place of ``device``) splits the lanes over D shards, shard
    d's on ``mesh[d]``: the bag is packed once on the host, padded to a
    multiple of D with inert identity lanes (converged at admission,
    dropped from the results and the metrics), and its stacked operands
    are cut along the lane axis.  The sharded solve is bit for bit the
    unsharded one — x, rr, iterations, statuses and trace — for every
    engine, layout and scheme; the mesh signature joins the runner's
    cache key (see :mod:`repro_torch.core.shard`).  ``interpret=`` has no
    counterpart: a CPU tensor takes each kernel's plain version, a CUDA
    tensor its kernel.
    """
    if interpret is not None:
        raise NotImplementedError(
            "interpret= has no counterpart in the torch port: a CPU tensor "
            "takes each kernel's plain version, a CUDA tensor its kernel")
    if engine != "vm" and (policy is not None or program is not None):
        raise ValueError(
            f"policy=/program= select the stream-VM's program; they have "
            f"no effect under engine={engine!r} — drop them or use "
            "engine='vm'")
    if policy is not None and program is not None:
        raise ValueError("pass either policy= (compiled for you) or "
                         "program= (pre-assembled), not both")
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if mesh is not None:
        if device is not None:
            raise ValueError("pass either device= or mesh= (the mesh names "
                             "the devices), not both")
        mesh = lane_mesh(mesh)
        device = torch.device("cpu")      # pack on the host, then cut
    else:
        device = resolve_device(device)
    scheme = get_scheme(scheme)
    csrs = [_as_csr(a) for a in problems]
    G = G_real = len(csrs)
    if G == 0:
        return []
    if layout in (None, "auto"):
        layout = choose_layout(
            csrs, default="rowell" if backend == "xla" else "ellpack")
    if mesh is not None:
        # Shard padding after the layout choice, which sees only the real
        # problems; a 1×1 identity lane changes no bucket dimension.
        G = pad_lanes(G_real, mesh)
        csrs = csrs + [_as_csr(np.eye(1))] * (G - G_real)
    mat, stacked, groups, n_col_tiles, bucket_dims = stack_operands(
        csrs, backend=backend, layout=layout, scheme=scheme, device=device,
        bucket=bucket, block_rows=block_rows, col_tile=col_tile)
    index_bytes = mat[2 if layout == "ellpack" else 0].element_size()

    vd = scheme.vector_dtype
    n_pad = stacked.padded_rows
    ns = [s[0] for s in stacked.shapes]
    # Padded rows get a unit diagonal and zero rhs: their residual is
    # identically zero, so they never influence rr or termination.
    diag = _pad_stack([a.diagonal() for a in csrs], n_pad, 1.0, vd, device)
    bs = list(bs) if bs is not None else [np.ones(n) for n in ns[:G_real]]
    x0s = (list(x0s) if x0s is not None
           else [np.zeros(n) for n in ns[:G_real]])
    for name, seq in (("bs", bs), ("x0s", x0s)):
        if len(seq) != G_real:
            raise ValueError(f"{name} has {len(seq)} entries for {G_real} "
                             "problems")
        for g, v in enumerate(seq):
            if np.shape(v) != (ns[g],):
                raise ValueError(
                    f"{name}[{g}] has shape {np.shape(v)}, expected "
                    f"({ns[g]},) for problem {g}")
    # shard-padding lanes: zero rhs and start on the identity lane
    pad_g = [np.zeros(1)] * (G - G_real)
    b = _pad_stack(bs + pad_g, n_pad, 0.0, vd, device)
    x0 = _pad_stack(x0s + pad_g, n_pad, 0.0, vd, device)
    if np.ndim(tol) == 0:
        tol_vec = torch.full((G,), float(tol), dtype=vd, device=device)
    else:
        if len(tol) != G_real:
            raise ValueError(f"tol has {len(tol)} entries for {G_real} "
                             "problems")
        tol_vec = torch.tensor(np.concatenate([
            np.asarray(tol, np.float64), np.ones(G - G_real)]), dtype=vd,
            device=device)
    operands = (mat, diag, b, x0, tol_vec)
    if mesh is not None:
        operands = tuple(place_lanes(mesh, a) for a in operands)

    from repro_torch.core.compile import executable_key
    runner_kw = dict(backend=backend, scheme=scheme, maxiter=maxiter,
                     with_trace=with_trace, layout=layout, groups=groups,
                     col_tile=col_tile, n_col_tiles=n_col_tiles,
                     steps_per_sync=steps_per_sync, detect=detect, mesh=mesh)
    key_kw = dict(backend=backend, scheme=scheme.name, batch=G,
                  bucket=bucket_dims, layout=layout, index_bytes=index_bytes,
                  maxiter=maxiter, with_trace=with_trace,
                  steps_per_sync=steps_per_sync, donate=False, detect=detect,
                  mesh=mesh)
    if engine == "vm":
        from repro_torch.core.compile import canonical_program
        from repro_torch.core.isa import BUF, SREG
        from repro_torch.core.vm import make_vm_runner
        if program is None:
            policy = "paper" if policy is None else policy
            program = canonical_program(policy)
            method = f"vm_batched[{policy}]"
        else:
            method = "vm_batched[custom]"
        prog_np = np.asarray(program, np.int32)
        if specialize:
            key = executable_key("vm_solve_spec", program=prog_np, **key_kw)
            run = _cached(key, lambda: make_vm_runner(program=prog_np,
                                                      **runner_kw))
            st = run(*operands)
        else:
            method += "|generic"
            run = _cached(executable_key("vm_solve", **key_kw),
                          lambda: make_vm_runner(**runner_kw))
            st = run(prog_np, *operands)

        def fields(s):
            return s.mem[BUF["x"]], s.sregs[SREG["rr"]], s.trace
    elif engine == "phases":
        key = executable_key("solve", **key_kw)
        run = _cached(key, lambda: _make_runner(**runner_kw))
        st = run(*operands)
        method = "vsr_batched"

        def fields(s):
            return s.x, s.rr, s.trace
    else:
        raise ValueError(f"unknown engine {engine!r}")

    shards = list(st) if mesh is not None else [st]
    per = G // len(shards)

    def lanes(t_of):
        return np.concatenate([t_of(s).cpu().numpy() for s in shards])

    its = lanes(lambda s: s.it)
    rrs = lanes(lambda s: fields(s)[1])
    tols = tol_vec.cpu().numpy()
    statuses = lanes(lambda s: s.status)
    traces = lanes(lambda s: fields(s)[2]) if with_trace else None

    # Observability (host-side estimates): one SpMV per warm-up, per
    # committed iteration, and per discarded in-loop breakdown tick;
    # streamed bytes = events × the lane's at-rest nonzero stream.
    # Shard-padding lanes (g ≥ G_real) are invisible to the accounting.
    m = solver_metrics()
    if layout == "ellpack":
        lane_stream_bytes = (_nbytes(mat[1]) + _nbytes(mat[2])) // G
    else:
        lane_stream_bytes = (_nbytes(mat[0]) + _nbytes(mat[1])) // G
    # A breakdown lane spent a discarded tick iff it entered the loop: an
    # in-loop breakdown freezes at its (finite) pre-tick rr, while a lane
    # latched non-finite at admission keeps its non-finite warm-up rr.
    n_bd = int(sum(is_breakdown(int(c)) and np.isfinite(rrs[g])
                   for g, c in enumerate(statuses[:G_real])))
    spmv_events = G_real + int(its[:G_real].sum()) + n_bd
    m.bump("solves")
    m.bump("lanes", G_real)
    m.bump("iterations", int(its[:G_real].sum()))
    m.bump("spmv_calls", spmv_events)
    m.bump("bytes_streamed_est", spmv_events * int(lane_stream_bytes))
    m.record_exits(statuses[:G_real])

    return [CGResult(
        x=fields(shards[g // per])[0][g % per, : ns[g]],
        iterations=int(its[g]), rr=float(rrs[g]),
        converged=bool(rrs[g] <= tols[g]),
        residual_trace=traces[g, : its[g]] if with_trace else None,
        scheme=scheme.name, method=method,
        status=status_name(int(statuses[g])) if with_status else None)
        for g in range(G_real)]
