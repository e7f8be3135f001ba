"""Row-distributed JPCG on ``torch.distributed`` (the torch port of
:mod:`repro.distributed.cg_dist`).

SPMD, one process per rank.  The rows of A are block-partitioned over the
ranks of one process group (the reference's mesh axes flattened to one
``rows`` axis, :func:`repro_torch.sparse.partition.partition_rows`); rank
k holds shard k of the banked-ELL matrix, its rows of every vector and its
share of ``diag``.  Per iteration:

* **SpMV** — the local banked-ELL product
  (:func:`repro_torch.core.operators.bell_spmv_torch`, the port of the
  plain ``bell_spmv_jnp`` the reference calls outside any kernel; its
  ``index_put_(accumulate=True)`` sums each row in a fixed order, so a
  solve repeats bit for bit) over an x-window assembled by
  ``comm="allgather"`` (one ``all_gather`` of p) or ``comm="halo"`` (two
  neighbour exchanges of ``halo_pad`` entries, posted as one
  ``batch_isend_irecv``; an edge rank receives zeros and reads
  :meth:`~repro_torch.sparse.partition.PartitionedMatrix.tile_cols_halo`);
* **dots** — a local ``torch.dot``, then an ``all_reduce``: ``vsr`` makes
  two an iteration (``p·ap``, then the packed ``[r·r, r·z]``), the paper's
  two scalar barriers; ``pipelined`` one, of the packed ``[γ, δ, ‖r‖²]``.

The iterations are the single-system loops'
(:func:`repro_torch.core.phases.jpcg_loop`,
:func:`repro_torch.core.pipelined.pipecg_loop`), given this SpMV and a
``reduce`` that all-reduces their packed partial dots.  So ``pipelined``
replaces its residual every
:data:`~repro_torch.core.pipelined.REPLACE_EVERY` iterations (r = b − A·x,
then u and w; two more SpMVs, no more reductions), as the single-system
loops of the port and the reference do.  The reference's distributed loop
does not; a copy of it without the replacement stalled short of the
paper's ‖r‖² < 1e-12 on ``poisson_2d(1000)`` on an H100 (rr 5.4e-9 after
20,000 iterations).

Termination: every rank reads the *all-reduced* ``rr`` on the host once an
iteration and takes the same branch.

:data:`COLLECTIVES` counts what a solve issues, by kind, with the bytes a
rank sends (all-gather: its shard to every other rank; halo: what it
posts; all-reduce: the ring's 2·(S−1)/S of the reduced elements).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.core.operators import bell_spmv_torch
from repro_torch.core.phases import init_state, jpcg_loop
from repro_torch.core.pipelined import pipecg_init, pipecg_loop
from repro_torch.core.precision import PrecisionScheme, get_scheme
from repro_torch.device import resolve_device, to_device
from repro_torch.sparse.partition import PartitionedMatrix, partition_rows

__all__ = ["DistCG", "make_dist_solver", "COLLECTIVES", "collectives",
           "reset_collectives", "AXIS"]

#: name of the one axis the rows are partitioned over (the process group's
#: ranks, in rank order)
AXIS = "rows"

#: Collectives issued since :func:`reset_collectives`, by kind, and the
#: bytes this rank sent in them.
COLLECTIVES: Dict[str, int] = dict.fromkeys(
    ("all_reduce", "all_gather", "halo", "bytes_sent"), 0)


def collectives() -> Dict[str, int]:
    return dict(COLLECTIVES)


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def _count(kind: str, nbytes: int) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVES["bytes_sent"] += int(nbytes)


@dataclasses.dataclass(frozen=True)
class DistCG:
    """A distributed solver bound to a process group and a partition:
    ``solve(b, x0, diag) -> (x, iterations, rr)`` takes global vectors of
    length n and returns the global x (on ``device``), the iterations and
    the final all-reduced ‖r‖², the same on every rank."""

    group: object
    part: PartitionedMatrix
    scheme: PrecisionScheme
    method: str
    comm: str
    device: torch.device
    solve: Callable


def _default_device(rank: int) -> torch.device:
    """``cuda:<local rank>``: ``LOCAL_RANK`` where a launcher set it, else
    the rank modulo the visible cards.  Raises without a card."""
    resolve_device(None)
    local = os.environ.get("LOCAL_RANK")
    local = int(local) if local is not None else \
        rank % torch.cuda.device_count()
    return torch.device("cuda", local)


def make_dist_solver(a, group=None, *, scheme="mixed_v3",
                     method: str = "pipelined", tol: float = 1e-12,
                     maxiter: int = 20_000, block_rows: int = 256,
                     col_tile: int = 512, comm: str = "auto",
                     part: Optional[PartitionedMatrix] = None,
                     device=None) -> DistCG:
    """Build a row-distributed JPCG over the ranks of ``group`` (default:
    the world), on ``device`` (default ``cuda:<local rank>``; an NCCL
    group needs a CUDA device).

    ``comm``: how the SpMV assembles its x-window —
      * ``"allgather"`` — gather the full vector (general matrices);
      * ``"halo"`` — two neighbour exchanges of ``halo_pad`` entries
        (stencil matrices: from (S−1)·R entries a rank to 2·halo);
      * ``"auto"`` — halo when the partition supports it and the halo is
        ≤ ¼ of the shard, else allgather.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_dist_solver needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    if method not in ("vsr", "pipelined"):
        raise ValueError(f"unknown method {method!r}")
    group = dist.group.WORLD if group is None else group
    scheme = get_scheme(scheme)
    vd = scheme.vector_dtype
    n_shards = dist.get_world_size(group)
    rank = dist.get_rank(group)
    device = (_default_device(rank) if device is None
              else resolve_device(device))
    if dist.get_backend(group) == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group needs a CUDA device, not {device}")
    if part is None:
        part = partition_rows(a, n_shards, block_rows=block_rows,
                              col_tile=col_tile)
    if part.n_shards != n_shards:
        raise ValueError(f"a partition of {part.n_shards} shards for a "
                         f"group of {n_shards} ranks")
    n = part.shape[0]
    rows_local = part.rows_per_shard
    n_pad = part.padded_cols
    if comm == "auto":
        comm = ("halo" if part.supports_halo
                and part.halo_pad * 4 <= rows_local else "allgather")
    if comm not in ("allgather", "halo"):
        raise ValueError(f"unknown comm {comm!r}")
    use_halo = comm == "halo"
    if use_halo and not part.supports_halo:
        raise ValueError("partition does not support halo exchange "
                         f"(halo={part.halo_width}, R={rows_local})")
    halo_pad = part.halo_pad if use_halo else 0
    win_pad = rows_local + 2 * halo_pad        # x-window length (halo)
    item = torch.empty((), dtype=vd).element_size()

    tile_cols = part.tile_cols_halo() if use_halo else part.tile_cols
    shard = (to_device(tile_cols[rank], device),
             to_device(part.vals[rank], device, scheme.matrix_dtype),
             to_device(part.local_rows[rank], device),
             to_device(part.local_cols[rank], device))
    peer = {r: dist.get_global_rank(group, r)
            for r in (rank - 1, rank + 1) if 0 <= r < n_shards}

    def local_spmv(x_win, length):
        if x_win.shape[0] >= length:          # row padding exceeds col padding
            x_pad = x_win[:length]
        else:
            x_pad = x_win.new_zeros(length)
            x_pad[: x_win.shape[0]] = x_win
        y = bell_spmv_torch(*shard, x_pad, block_rows=part.block_rows,
                            col_tile=part.col_tile, scheme=scheme)
        return y[:rows_local]

    def spmv(p_local):
        if use_halo:
            # left neighbour's tail and right neighbour's head; an edge rank
            # keeps zeros, matching the absent boundary columns
            left = p_local.new_zeros(halo_pad)
            right = p_local.new_zeros(halo_pad)
            ops = []
            if rank + 1 in peer:
                ops += [dist.P2POp(dist.isend, p_local[-halo_pad:],
                                   peer[rank + 1], group),
                        dist.P2POp(dist.irecv, right, peer[rank + 1], group)]
            if rank - 1 in peer:
                ops += [dist.P2POp(dist.isend, p_local[:halo_pad],
                                   peer[rank - 1], group),
                        dist.P2POp(dist.irecv, left, peer[rank - 1], group)]
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            _count("halo", len(ops) // 2 * halo_pad * item)
            window = torch.cat([left, p_local, right])
            return local_spmv(window.to(scheme.spmv_in_dtype), win_pad)
        parts = [torch.empty_like(p_local) for _ in range(n_shards)]
        dist.all_gather(parts, p_local, group=group)
        _count("all_gather", (n_shards - 1) * rows_local * item)
        return local_spmv(torch.cat(parts).to(scheme.spmv_in_dtype), n_pad)

    def all_reduce(*partials):
        """Sum this rank's partial dots over the group: one all-reduce of
        them packed."""
        v = torch.stack(partials)
        dist.all_reduce(v, group=group)
        _count("all_reduce",
               2 * (n_shards - 1) * v.numel() * item // n_shards)
        return v.unbind()

    def kern(b, x0, d):
        if method == "vsr":
            st = init_state(spmv, d, b, x0, maxiter=maxiter, scheme=scheme,
                            with_trace=False, reduce=all_reduce)
            st = jpcg_loop(spmv, d, st, tol=tol, maxiter=maxiter,
                           scheme=scheme, reduce=all_reduce)
        else:
            st = pipecg_init(spmv, d, b, x0, maxiter=maxiter, scheme=scheme,
                             with_trace=False, reduce=all_reduce)
            st = pipecg_loop(spmv, d, b, st, tol=tol, maxiter=maxiter,
                             scheme=scheme, reduce=all_reduce)
        return st.x, int(st.i), st.rr

    n_rows_pad = part.padded_rows
    lo = rank * rows_local

    def local(v, fill):
        """This rank's rows of a global vector, padded with ``fill``
        (``diag`` with 1, so the padded rows solve the identity)."""
        out = torch.full((n_rows_pad,), fill, dtype=vd, device=device)
        out[:n] = to_device(v, device, vd)
        return out[lo:lo + rows_local]

    def solve(b, x0, diag):
        """b / x0 / diag: global vectors of length n."""
        x, i, rr = kern(local(b, 0.0), local(x0, 0.0), local(diag, 1.0))
        parts = [torch.empty_like(x) for _ in range(n_shards)]
        dist.all_gather(parts, x.contiguous(), group=group)
        _count("all_gather", (n_shards - 1) * rows_local * item)
        return torch.cat(parts)[:n], i, float(rr)

    return DistCG(group=group, part=part, scheme=scheme, method=method,
                  comm=comm, device=device, solve=solve)
