"""Slot-based CG solver engine — continuous batching on the stream VM (the
torch port of :mod:`repro.serve.solver_engine`).

Every tick runs one chunked VM step (≤ ``chunk_iters`` executions of the
pool's compiled program) over a fixed pool of problem slots.  Slots are
independent — each carries its own tolerance, iteration budget and
``active`` flag — so a new system is admitted the moment an old one
finishes, without disturbing in-flight lanes.

Requests are grouped into **pools** keyed by ``(scheme, policy)``; each
pool owns ``batch_slots`` slots, its own bucket (padded operand shape,
sized from the first admitted problem and grown on demand), its own
matrix layout (resolved at first admit by the padding-ratio heuristic
when ``layout="auto"``) and its own program.  By default each pool steps
through a stepper specialized to its program; with
``SolverEngineConfig(specialize=False)`` the program is an operand of one
generic stepper per bucket, so pools that differ only in policy share
it (bitwise the same results).  Every scheme runs, the TPU tier's
(``tpu_*``, bf16 values) included.

Admission packs the problem into a free slot and runs the JPCG warm-up
(r₀ = b − A·x₀, z₀ = M⁻¹r₀) for that lane through the pool's own SpMV —
the CUDA kernel of its layout on the card — and the batch runner's
row-wise dot.  (The reference spells the warm-up dot ``jnp.dot``, a
different reduction order: the port agrees with it to the solve
tolerance, not bitwise.)

State handling mirrors the reference: bucket and lane growth copy every
in-flight lane (``mem``, ``sregs`` **and** ``queues``); frozen lanes stay
bit-stable; each step *donates* the pool's state to the stepper, which
updates it in place, so :meth:`_Pool.harvest` copies results to the host
first; below ``compact_fraction`` occupancy live lanes are repacked into
the smallest power-of-two lane bucket (bitwise neutral per lane).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.batch import (_as_csr, _matvec_factory, _nbytes,
                                    _row_dot, batch_cache_info)
from repro_torch.core.cg import CGResult
from repro_torch.core.compile import canonical_program
from repro_torch.core.isa import BUF, SREG
from repro_torch.core.metrics import (Metrics, STATUS_MAXITER,
                                      STATUS_RUNNING, initial_status,
                                      is_breakdown, is_breakdown_codes,
                                      status_name)
from repro_torch.core.precision import (get_scheme, host_values,
                                        values_tensor)
from repro_torch.core.shard import Shards, lane_mesh, shard_any
from repro_torch.core.vm import BatchedVMState, make_vm_stepper
from repro_torch.device import resolve_device
from repro_torch.kernels.spmv import sell_table
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.ellpack import csr_to_ellpack
from repro_torch.sparse.stacking import (SELL_SLICE_ROWS, _sell_groups,
                                         bucket_up, choose_layout,
                                         csr_rowell, index_dtype,
                                         lane_bucket_up,
                                         pad_ellpack, sell_slice_widths,
                                         stack_sell)

__all__ = ["SolverEngineConfig", "SolverEngine"]


@dataclasses.dataclass(frozen=True)
class SolverEngineConfig:
    batch_slots: int = 8              # slots per (scheme, policy) pool
    scheme: str = "mixed_v3"          # default; per-request override
    policy: str = "paper"             # default VSR policy; per-request
    tol: float = 1e-12                # default; per-request override
    maxiter: int = 20_000             # default; per-request override
    chunk_iters: int = 64             # iterations per tick
    block_rows: int = 256
    col_tile: int = 512
    backend: str = "xla"              # "xla" | "pallas" (default layout)
    layout: str = "auto"              # "auto" | "rowell" | "sell" (xla)
    #                                   "auto" | "ellpack" | "sell" (pallas);
    #                                   auto resolves per pool at first admit
    specialize: bool = True           # program-specialized steppers; False:
    #                                   one generic stepper per bucket runs
    #                                   every pool's program as an operand
    steps_per_sync: int = 8           # VM ticks per termination sync
    donate: bool = True               # step the pool state in place
    compact_fraction: float = 0.5     # repack lanes when live/lanes < this
    detect: bool = True               # in-loop breakdown detection
    escalate_fp64: bool = False       # retry a breakdown once at fp64
    escalate_scheme: str = "fp64"     # where escalation re-routes to
    device: Optional[str] = None      # None = "cuda"
    mesh: Optional[tuple] = None      # lane mesh (repro_torch.core.shard
    #                                   .lane_mesh) in place of device:
    #                                   each pool's lanes split over it


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view: donating steps rewrite state in place)."""
    return t.to("cpu", copy=True).numpy()


class _Pool:
    """Slots + VM state for one (scheme, policy) request class.

    The slots split into ``n_dev`` lane shards of ``slots / n_dev`` each:
    slot s lives on shard ``s // (slots / n_dev)``, whose operand, VM
    state, tolerances and budgets sit on ``devices[d]`` (one shard, on the
    engine's device, without a mesh).  A lane never leaves its shard:
    growth and compaction are device-local."""

    def __init__(self, cfg: SolverEngineConfig, scheme, policy: str,
                 devices: Tuple[torch.device, ...], mesh=None,
                 metrics: Optional[Metrics] = None):
        self.cfg = cfg
        self.scheme = scheme
        self.policy = policy
        self.devices = devices
        self.mesh = mesh
        self.n_dev = len(devices)
        self.metrics = metrics if metrics is not None else Metrics()
        self.program_np = np.asarray(canonical_program(policy), np.int32)
        self.capacity = (cfg.batch_slots if mesh is None else
                         lane_bucket_up(cfg.batch_slots, parts=self.n_dev))
        self.slots = self.capacity               # current lane capacity
        self.req_of_slot: list = [None] * self.slots   # request id or None
        self.n_of_slot = np.zeros(self.slots, np.int64)  # logical n per slot
        self.csr_of_slot: list = [None] * self.slots  # kept for sell rebuild
        self.bucket = None                       # per-layout dims tuple
        self.mats: list = []                     # per shard: its operand
        self.states: list = []                   # per shard: BatchedVMState
        self.tols: list = []                     # per shard: tol[lanes]
        self.maxiters: list = []                 # per shard: budgets
        self.layout = None if cfg.layout == "auto" else cfg.layout
        self.sell_widths = None                  # per-slice widths (sell)
        self.lane_widths = None                  # host int32[slots, slices]
        self.groups = None                       # static (rows, w) runs

    # ------------------------------------------------------------ shards
    @property
    def mat(self):
        """The operand: one shard's tuple, or a ``Shards`` under a mesh."""
        return self._view(self.mats)

    @property
    def state(self) -> Optional[BatchedVMState]:
        """The VM state: one shard's, or a ``Shards`` under a mesh."""
        return self._view(self.states) if self.states else None

    def _view(self, per_shard):
        return Shards(per_shard) if self.mesh is not None else per_shard[0]

    @property
    def _per(self) -> int:
        return self.slots // self.n_dev

    def _loc(self, s: int) -> Tuple[int, int]:
        """(shard, lane within it) of slot ``s``."""
        return divmod(s, self._per)

    def _lanes(self, t_of) -> np.ndarray:
        """A host copy of a per-lane state tensor over every slot."""
        self.metrics.count("host_syncs", len(self.states))
        return np.concatenate([_host(t_of(st)) for st in self.states])

    def _lane_round(self, want: int) -> int:
        """Next lane-bucket edge, one the shard count divides."""
        return (bucket_up(want) if self.mesh is None
                else lane_bucket_up(want, parts=self.n_dev))

    # ------------------------------------------------------------ sizing
    @property
    def _ellpack(self) -> bool:
        return self.cfg.backend == "pallas" and self.layout != "sell"

    def _n_pad(self, dims):
        return dims[0] * self.cfg.block_rows if self._ellpack else dims[0]

    def _tensor(self, a, d: int, dtype=None) -> torch.Tensor:
        """A host array on shard ``d``'s device (bf16 values through their
        bits, :func:`repro_torch.core.precision.values_tensor`)."""
        self.metrics.count("h2d_bytes", np.asarray(a).nbytes)
        return values_tensor(a, self.devices[d], dtype)

    def _sell_mat(self, arrays, lane_widths, d: int) -> tuple:
        """``(cols, vals, iperm)`` plus the SELL kernel's table for these
        lanes on shard ``d``, built on the host from their widths (so the
        launch grid is known without reading the device)."""
        return tuple(arrays[:3]) + (sell_table(
            self.groups, device=self.devices[d], lane_widths=lane_widths,
            slice_rows=max(1, min(SELL_SLICE_ROWS, self.bucket[0]))),)

    def _shard_widths(self, d: int) -> np.ndarray:
        return self.lane_widths[d * self._per:(d + 1) * self._per]

    def _lane_mat(self, s: int) -> tuple:
        """The operand of slot ``s`` alone (the admission warm-up's)."""
        d, j = self._loc(s)
        if self.layout == "sell":
            return self._sell_mat([arr[j:j + 1] for arr in self.mats[d][:3]],
                                  self.lane_widths[s:s + 1], d)
        return tuple(arr[j:j + 1] for arr in self.mats[d])

    def _alloc(self, dims):
        """(Re)allocate the slot-stacked tensors for bucket ``dims`` at the
        current lane capacity, copying every in-flight lane.

        Serves first admission, bucket growth and lane regrowth after
        compaction.  Row-ELL and ELLPACK operands grow by copy-and-pad;
        sliced-ELL is rebuilt from the retained per-slot CSRs (shared
        slice widths move the flat offsets).  VM state is layout-
        independent and always copied forward: ``mem``, ``sregs`` and
        ``queues``.  A lane keeps its shard: lane j of shard d stays lane
        j of shard d, whatever the new lanes per shard.
        """
        S, D = self.slots, self.n_dev
        per = S // D
        vd = self.scheme.vector_dtype
        md = self.scheme.matrix_dtype
        n_pad = self._n_pad(dims)
        old_mats, old_states = self.mats, self.states
        old_S = len(self.req_of_slot)
        if old_S < S:
            # device-local regrowth: shard d's old lanes keep their places
            # at the head of its new block
            old_per = old_S // D
            where = np.array([d * per + j for d in range(D)
                              for j in range(old_per)], np.int64)
            req, csr = [None] * S, [None] * S
            n_of = np.zeros(S, np.int64)
            for o, s in enumerate(where):
                req[s], csr[s] = self.req_of_slot[o], self.csr_of_slot[o]
                n_of[s] = self.n_of_slot[o]
            self.req_of_slot, self.csr_of_slot, self.n_of_slot = \
                req, csr, n_of

        if self.layout == "sell":
            # Full rebuild at the pool's shared geometry; empty slots get
            # a zero-nnz placeholder (self-gathering pad entries only).
            empty = CSRMatrix(np.zeros(2, np.int64), np.zeros(0, np.int32),
                              np.zeros(0, np.float64), (1, 1))
            stacked = stack_sell(
                [c if c is not None else empty for c in self.csr_of_slot],
                n_pad=n_pad, widths=self.sell_widths, scheme=self.scheme)
            self._count_packed(stacked.cols, stacked.vals, stacked.iperm,
                               nnz=sum(c.nnz for c in self.csr_of_slot
                                       if c is not None))
            self.groups = stacked.groups
            self.lane_widths = stacked.lane_widths
            self.bucket = dims
            mats = []
            for d in range(D):
                lanes = slice(d * per, (d + 1) * per)
                mats.append(self._sell_mat(
                    (self._tensor(stacked.cols[lanes], d),
                     self._tensor(stacked.vals[lanes], d, md),
                     self._tensor(stacked.iperm[lanes], d, torch.int64)),
                    self._shard_widths(d), d))
        elif not self._ellpack:
            N, W = dims
            idt = torch.int16 if index_dtype(N) == np.int16 else torch.int32
            # padding entries are (col i, val 0) for row i: self-gather,
            # so no lane can be poisoned through another row's x entry
            mats = [(torch.arange(N, dtype=idt, device=dev).expand(
                        per, W, N).contiguous(),
                     torch.zeros((per, W, N), dtype=md, device=dev))
                    for dev in self.devices]
        else:
            B, T, L, _ = dims
            R = self.cfg.block_rows
            mats = [(torch.zeros((per, B, T), dtype=torch.int32, device=dev),
                     torch.zeros((per, B, T, L, R), dtype=md, device=dev),
                     torch.zeros((per, B, T, L, R), dtype=torch.int32,
                                 device=dev))
                    for dev in self.devices]
        states, tols, maxiters = [], [], []
        for d, dev in enumerate(self.devices):
            mem = torch.zeros((6, per, n_pad), dtype=vd, device=dev)
            mem[BUF["M"]] = 1.0                  # unit diag on empty rows
            state = BatchedVMState(
                k=torch.zeros((), dtype=torch.int32, device=dev),
                it=torch.zeros(per, dtype=torch.int32, device=dev),
                status=torch.zeros(per, dtype=torch.int32, device=dev),
                mem=mem,
                queues=torch.zeros((8, per, n_pad), dtype=vd, device=dev),
                sregs=torch.zeros((6, per), dtype=vd, device=dev),
                active=torch.zeros(per, dtype=torch.bool, device=dev),
                trace=torch.zeros((per, 0), dtype=vd, device=dev))
            tol = torch.full((per,), self.cfg.tol, dtype=vd, device=dev)
            maxiter_vec = torch.zeros(per, dtype=torch.int32, device=dev)
            if old_states:
                # Growing bucket and/or lane count: copy every old lane
                # into the new tensors (padded tails stay what a wider VM
                # would hold for rows that never existed).
                def corner(t):
                    return tuple(slice(0, n) for n in t.shape)

                if self.layout != "sell":
                    # the old region is valid verbatim (row-ELL pads self-
                    # gather; ELLPACK pads are zero); the copy also widens
                    # int16 cols to int32 when N crossed 2^15
                    for new, old in zip(mats[d], old_mats[d]):
                        new[corner(old)] = old.to(new.dtype)
                old_st = old_states[d]
                for name in ("it", "status", "sregs", "active", "mem",
                             "queues"):
                    old = getattr(old_st, name)
                    getattr(state, name)[corner(old)] = old
                state = state._replace(k=old_st.k.clone())
                tol[: self.tols[d].shape[0]] = self.tols[d]
                maxiter_vec[: self.maxiters[d].shape[0]] = self.maxiters[d]
            states.append(state)
            tols.append(tol)
            maxiters.append(maxiter_vec)
        if old_states:
            self.metrics.bump("growths")
        self.bucket = dims
        self.mats, self.states = mats, states
        self.tols, self.maxiters = tols, maxiters

    def _matvec_of(self):
        return _matvec_factory(
            backend=self.cfg.backend, scheme=self.scheme, layout=self.layout,
            groups=self.groups, col_tile=self.cfg.col_tile,
            n_col_tiles=self.bucket[-1] if self._ellpack else None)

    # ---------------------------------------------------------- admission
    def admit(self, a, b, x0, tol, maxiter) -> int:
        """Place one system into a free slot; returns the slot index.

        With tracing on, its host packing, growth, host-to-device copies
        and warm-up are the spans ``admit.pack``, ``admit.grow``,
        ``admit.copy`` and ``admit.warmup`` (module docstring of
        :mod:`repro_torch.core.metrics`)."""
        span = self.metrics.span
        free = [s for s, r in enumerate(self.req_of_slot) if r is None]
        if not free and self.slots < self.capacity:
            # Compaction shrank the pool; grow lanes back for this admit.
            self.slots = min(self.capacity, self._lane_round(self.slots + 1))
            with span("admit.grow"):
                self._alloc(self.bucket)
            free = [s for s, r in enumerate(self.req_of_slot) if r is None]
        if not free:
            raise RuntimeError(
                f"no free solver slots in pool "
                f"(scheme={self.scheme.name}, policy={self.policy})")
        s = free[0]
        cfg = self.cfg
        with span("admit.pack"):
            a = _as_csr(a)
            if self.layout is None:
                self.layout = choose_layout(
                    [a], default="rowell" if cfg.backend == "xla"
                    else "ellpack")
        if self.layout == "sell":
            with span("admit.pack"):
                n_pad = bucket_up(a.shape[0])
                if self.bucket is not None:
                    n_pad = max(n_pad, self.bucket[0])
                stored = [c for c in self.csr_of_slot if c is not None]
                wnew = sell_slice_widths(stored + [a], n_pad=n_pad)
                if self.sell_widths is not None:
                    # n_pad growth appends zero-nnz rows, which the global
                    # sort sends to the tail: old slice widths stay valid
                    # for the leading slices, so the merge is a zero-padded
                    # max.
                    old = self.sell_widths + (0,) * (len(wnew) -
                                                     len(self.sell_widths))
                    wnew = tuple(max(o, w) for o, w in zip(old, wnew))
            self.csr_of_slot[s] = a
            if (self.bucket is None or n_pad != self.bucket[0]
                    or wnew != self.sell_widths):
                self.sell_widths = wnew
                groups = _sell_groups(wnew, n_pad=n_pad,
                                      slice_rows=max(1, min(SELL_SLICE_ROWS,
                                                            n_pad)))
                with span("admit.grow"):
                    self._alloc((n_pad,) + tuple(
                        d for rw in groups for d in rw))
            else:
                with span("admit.pack"):
                    st1 = stack_sell([a], n_pad=n_pad,
                                     widths=self.sell_widths,
                                     scheme=self.scheme)
                self._count_packed(st1.cols, st1.vals, st1.iperm,
                                   nnz=a.nnz)
                with span("admit.copy"):
                    d, j = self._loc(s)
                    arrays = self.mats[d][:3]
                    for arr, lane in zip(arrays, (st1.cols[0], st1.vals[0],
                                                  st1.iperm[0])):
                        arr[j] = self._tensor(lane, d, arr.dtype)
                    self.lane_widths[s] = st1.lane_widths[0]
                    self.mats[d] = self._sell_mat(arrays,
                                                  self._shard_widths(d), d)
        else:
            with span("admit.pack"):
                if cfg.backend == "xla":
                    cols_l, vals_l = csr_rowell(a)
                    dims = (bucket_up(a.shape[0]),
                            bucket_up(cols_l.shape[1]))
                else:
                    m = csr_to_ellpack(a, block_rows=cfg.block_rows,
                                       col_tile=cfg.col_tile)
                    dims = tuple(bucket_up(d) for d in (
                        m.n_row_blocks, m.n_slabs, m.ell, m.n_col_tiles))
            if self.bucket is None or any(d > o for d, o in
                                          zip(dims, self.bucket)):
                grown = dims if self.bucket is None else tuple(
                    max(d, o) for d, o in zip(dims, self.bucket))
                with span("admit.grow"):
                    self._alloc(grown)
            with span("admit.pack"):
                if cfg.backend == "xla":
                    # slot-major lane slab over the whole bucket: self-
                    # gather template, then the real entries transposed in
                    N, W = self.bucket
                    n, w_a = cols_l.shape
                    lane_cols = np.broadcast_to(
                        np.arange(N, dtype=index_dtype(N)), (W, N)).copy()
                    lane_cols[:w_a, :n] = cols_l.T
                    lane_vals = np.zeros((W, N),
                                         self.scheme.host_matrix_dtype)
                    lane_vals[:w_a, :n] = host_values(
                        vals_l.T, self.scheme.host_matrix_dtype)
                    lanes = (lane_cols, lane_vals)
                else:
                    B, T, L, _ = self.bucket
                    m = pad_ellpack(m, n_row_blocks=B, n_slabs=T, ell=L)
                    lanes = (m.tile_cols, m.vals, m.local_cols)
            self._count_packed(*lanes, nnz=a.nnz)
            self.csr_of_slot[s] = a
            with span("admit.copy"):
                d, j = self._loc(s)
                for arr, lane in zip(self.mats[d], lanes):
                    arr[j] = self._tensor(lane, d, arr.dtype)

        vd = self.scheme.vector_dtype
        d, j = self._loc(s)
        n = a.shape[0]
        st = self.states[d]
        n_pad = st.mem.shape[-1]
        with span("admit.pack"):
            dg = np.ones(n_pad)
            dg[:n] = a.diagonal()
            bb = np.zeros(n_pad)
            bb[:n] = np.ones(n) if b is None else np.asarray(b)
            xx = np.zeros(n_pad)
            if x0 is not None:
                xx[:n] = np.asarray(x0)
        self._count_packed(dg, bb, xx)
        with span("admit.copy"):
            diag_l = self._tensor(dg[None], d, vd)
            b_l = self._tensor(bb[None], d, vd)
            x0_l = self._tensor(xx[None], d, vd)

        with span("admit.warmup"):
            # JPCG warm-up for this lane alone, through the pool's own SpMV.
            r = b_l - self._matvec_of()(self._lane_mat(s))(x0_l)
            z = r / diag_l
            rz, rr = _row_dot(r, z)[0], _row_dot(r, r)[0]

            req_tol = torch.tensor(cfg.tol if tol is None else tol,
                                   dtype=vd, device=self.devices[d])
            st.it[j] = 0
            st.mem[:, j] = torch.cat([x0_l, r, z, torch.zeros_like(r),
                                      diag_l, b_l])
            st.queues[:, j] = 0.0
            st.sregs[:, j] = 0.0
            st.sregs[SREG["rz"], j] = rz
            st.sregs[SREG["rr"], j] = rr
            st.active[j] = rr > req_tol
            st.status[j] = initial_status(rr, req_tol, detect=cfg.detect)
            self.tols[d][j] = req_tol
            self.maxiters[d][j] = cfg.maxiter if maxiter is None else maxiter
        self.n_of_slot[s] = n
        self.metrics.bump("admits")
        self.metrics.bump("spmv_calls")          # the warm-up r0 = b - A·x0
        self.metrics.bump("bytes_streamed_est", self._lane_stream_bytes())
        return s

    def _count_packed(self, *arrays, nnz: int = 0) -> None:
        """Count host packing: ``nnz`` nonzeros into ``arrays``."""
        self.metrics.count("packed_nnz", nnz)
        self.metrics.count("packed_bytes", sum(a.nbytes for a in arrays))

    def _lane_stream_bytes(self) -> int:
        """At-rest nonzero stream per lane per SpMV: packed values +
        column indices, padding included, from the slot-stacked tensors."""
        pick = slice(1, 3) if self._ellpack else slice(0, 2)
        return int(sum(_nbytes(t) for mat in self.mats
                       for t in mat[pick])) // self.slots

    # -------------------------------------------------------------- tick
    @property
    def any_active(self) -> bool:
        if not self.states:
            return False
        self.metrics.count("host_syncs")
        return shard_any(st.active for st in self.states)

    def active_lanes(self) -> np.ndarray:
        """Host copy of every slot's ``active`` flag."""
        return self._lanes(lambda st: st.active)

    def step(self) -> None:
        cfg = self.cfg
        stepper_kw = dict(
            backend=cfg.backend, scheme=self.scheme, bucket=self.bucket,
            chunk=cfg.chunk_iters, layout=self.layout, groups=self.groups,
            index_bytes=self.mats[0][2 if self._ellpack else 0]
            .element_size(),
            col_tile=cfg.col_tile,
            n_col_tiles=self.bucket[-1] if self._ellpack else None,
            steps_per_sync=cfg.steps_per_sync, donate=cfg.donate,
            detect=cfg.detect, mesh=self.mesh)
        m = self.metrics
        # Host copies of the pre-step counters: a donating step updates
        # the state tensors in place.
        with m.span("step.account"):
            it0 = self._lanes(lambda st: st.it)
            st0 = self._lanes(lambda st: st.status)
        args = (self.mat, self.state, self._view(self.tols),
                self._view(self.maxiters))
        with m.span("step.vm"):
            if cfg.specialize:
                stepper = make_vm_stepper(program=self.program_np,
                                          **stepper_kw)
                out = stepper(*args)
            else:
                stepper = make_vm_stepper(**stepper_kw)
                out = stepper(self.program_np, *args)
        self.states = list(out) if self.mesh is not None else [out]
        # Accounting: committed iterations plus one discarded program
        # execution per lane that broke down during this step (its tick
        # ran the SpMV before the writes were thrown away).  Frozen
        # lanes' dead compute is deliberately not counted.
        with m.span("step.account"):
            it_delta = int((self._lanes(lambda st: st.it) - it0).sum())
            broke = int((is_breakdown_codes(
                self._lanes(lambda st: st.status))
                & ~is_breakdown_codes(st0)).sum())
        m.bump("chunks")
        m.bump("iterations", it_delta)
        m.bump("spmv_calls", it_delta + broke)
        m.bump("bytes_streamed_est",
               (it_delta + broke) * self._lane_stream_bytes())

    def harvest(self) -> Dict[int, CGResult]:
        if not self.states:
            return {}
        done: Dict[int, CGResult] = {}
        active = self.active_lanes()
        its = self._lanes(lambda st: st.it)
        statuses = self._lanes(lambda st: st.status)
        rrs = self._lanes(lambda st: st.sregs[SREG["rr"]])
        tols = np.concatenate([_host(t) for t in self.tols])
        count = self.metrics.count
        count("host_syncs", len(self.tols))
        count("d2h_bytes", sum(a.nbytes for a in (active, its, statuses, rrs,
                                                  tols)))
        for s, rid in enumerate(self.req_of_slot):
            if rid is None or active[s]:
                continue
            n = int(self.n_of_slot[s])
            d, j = self._loc(s)
            # A host copy: the next donating step rewrites mem in place.
            x = self.states[d].mem[BUF["x"], j, :n].to("cpu", copy=True)
            count("host_syncs")
            count("d2h_bytes", x.numel() * x.element_size())
            # An inactive lane still RUNNING is the detection-off
            # non-finite-at-admit corner; it wears the budget face.
            code = int(statuses[s])
            if code == STATUS_RUNNING:
                code = STATUS_MAXITER
            done[rid] = CGResult(
                x=x, iterations=int(its[s]),
                rr=float(rrs[s]), converged=bool(rrs[s] <= tols[s]),
                residual_trace=None, scheme=self.scheme.name,
                method=f"vm_engine[{self.policy}]",
                status=status_name(code))
            self.req_of_slot[s] = None
            # release the CSR: a departed lane must not keep inflating
            # future sell width merges (widths stay monotone regardless)
            self.csr_of_slot[s] = None
            self.metrics.bump("harvests")
        return done

    # --------------------------------------------------------- compaction
    def maybe_compact(self) -> bool:
        """Repack live lanes into a smaller lane bucket when the occupied
        fraction drops strictly below ``cfg.compact_fraction`` (step
        boundaries only).  Every VM op is lane-independent, so repacking
        is bitwise neutral per lane.  Returns True if the pool was
        repacked.

        Compaction is device-local: each shard repacks its own live lanes
        (moving a live lane would carry its in-flight state to another
        device), into a per-shard lane bucket sized by the fullest shard,
        so every shard keeps the same lane count."""
        if not self.states:
            return False
        S, D, per = self.slots, self.n_dev, self._per
        occ = [s for s, r in enumerate(self.req_of_slot) if r is not None]
        live = len(occ)
        if live == 0:
            return False
        by_shard = [[s for s in occ if s // per == d] for d in range(D)]
        t_per = bucket_up(max(len(o) for o in by_shard))
        target = t_per * D
        if target >= S or live / S >= self.cfg.compact_fraction:
            return False
        sel = np.asarray([s for d, o in enumerate(by_shard)
                          for s in (o + [s for s in range(d * per,
                                                          (d + 1) * per)
                                         if self.req_of_slot[s] is None]
                                    )[:t_per]], np.int64)
        if self.layout == "sell":
            self.lane_widths = self.lane_widths[sel]
        self.req_of_slot = [self.req_of_slot[s] for s in sel]
        self.csr_of_slot = [self.csr_of_slot[s] for s in sel]
        self.n_of_slot = self.n_of_slot[sel]
        self.slots = target
        for d in range(D):
            idx = torch.from_numpy(sel[d * t_per:(d + 1) * t_per]
                                   - d * per).to(self.devices[d])
            if self.layout == "sell":
                self.mats[d] = self._sell_mat(
                    [arr[idx] for arr in self.mats[d][:3]],
                    self._shard_widths(d), d)
            else:
                self.mats[d] = tuple(arr[idx] for arr in self.mats[d])
            st = self.states[d]
            self.states[d] = st._replace(
                it=st.it[idx], status=st.status[idx], mem=st.mem[:, idx],
                queues=st.queues[:, idx], sregs=st.sregs[:, idx],
                active=st.active[idx], trace=st.trace[idx])
            self.tols[d] = self.tols[d][idx]
            self.maxiters[d] = self.maxiters[d][idx]
        self.metrics.bump("compactions")
        return True


class SolverEngine:
    """Admit SPD systems into batch slots; solve them on the stream VM on
    ``cfg.device`` (default ``"cuda"``), or with their lanes split over
    ``cfg.mesh`` (:mod:`repro_torch.core.shard`)."""

    def __init__(self, cfg: SolverEngineConfig):
        self.cfg = cfg
        if cfg.mesh is not None:
            if cfg.device is not None:
                raise ValueError("SolverEngineConfig takes either device= "
                                 "or mesh= (the mesh names the devices)")
            self.mesh = lane_mesh(cfg.mesh)
            self.devices = self.mesh
        else:
            self.mesh = None
            self.devices = (resolve_device(cfg.device),)
        self.device = self.devices[0]
        self._pools: Dict[Tuple[str, str], _Pool] = {}
        self._next_id = 0
        self.results: Dict[int, CGResult] = {}
        self._metrics = Metrics()
        # Request meta for the escalation policy: rid -> (a, b, x0, tol,
        # maxiter, policy).  Only populated when cfg.escalate_fp64 is on.
        self._meta: Dict[int, tuple] = {}
        self._retried: set = set()

    def _pool(self, scheme: Optional[str], policy: Optional[str]) -> _Pool:
        scheme = get_scheme(self.cfg.scheme if scheme is None else scheme)
        policy = self.cfg.policy if policy is None else policy
        key = (scheme.name, policy)
        if key not in self._pools:
            self._pools[key] = _Pool(self.cfg, scheme, policy, self.devices,
                                     self.mesh, self._metrics)
        return self._pools[key]

    def metrics(self) -> dict:
        """Engine observability snapshot — a plain dict (json-safe).

        Counters: ``admits`` / ``harvests`` / ``escalations``, ``chunks``
        / ``iterations`` / ``spmv_calls`` / ``bytes_streamed_est`` (SpMV
        events × the per-lane at-rest nonzero stream), ``growths`` /
        ``compactions``; ``exit_status`` is the histogram of recorded
        request exits; ``pools`` reports per-(scheme, policy) occupancy
        and lane ``shards``; ``executable_cache`` is
        :func:`repro_torch.core.batch.batch_cache_info`.

        While tracing is on (a ``torch.profiler`` session in the process,
        or :func:`repro_torch.core.metrics.enable_tracing`), and only
        then, the snapshot also carries each span's ``"<name>.ns"`` and
        ``"<name>.n"`` — ``submit`` (root, its id the request id) over
        ``submit.harvest``, ``admit.pack``, ``admit.grow``,
        ``admit.copy``, ``admit.warmup``; ``step`` (root) over
        ``step.account``, ``step.vm``, ``step.harvest``, ``step.compact``
        — and the traced counters ``host_syncs``, ``packed_nnz``,
        ``packed_bytes``, ``h2d_bytes``, ``d2h_bytes`` and
        ``spans_dropped`` (:mod:`repro_torch.core.metrics`).
        """
        pools = {
            f"{sch}/{pol}": {
                "slots": p.slots,
                "shards": p.n_dev,
                "occupied": sum(r is not None for r in p.req_of_slot),
                "active": (int(p.active_lanes().sum()) if p.states else 0),
            }
            for (sch, pol), p in self._pools.items()}
        return self._metrics.snapshot(extra={
            "pools": pools, "executable_cache": batch_cache_info()})

    # ------------------------------------------------------------ public
    def free_slots(self, pool: Optional[Tuple[Optional[str],
                                              Optional[str]]] = None) -> int:
        """Free solver slots summed over every instantiated pool (before
        any pool exists: ``cfg.batch_slots``); ``pool=(scheme, policy)``
        gives one pool's view (an uninstantiated pool reports its full
        capacity)."""
        def pool_free(p: Optional[_Pool]) -> int:
            if p is None:
                return (self.cfg.batch_slots if self.mesh is None else
                        lane_bucket_up(self.cfg.batch_slots,
                                       parts=len(self.mesh)))
            return p.capacity - sum(r is not None for r in p.req_of_slot)

        if pool is not None:
            scheme, policy = pool
            key = (get_scheme(self.cfg.scheme if scheme is None
                              else scheme).name,
                   self.cfg.policy if policy is None else policy)
            return pool_free(self._pools.get(key))
        if not self._pools:
            return pool_free(None)
        return sum(pool_free(p) for p in self._pools.values())

    @property
    def active_count(self) -> int:
        return sum(int(p.active_lanes().sum()) for p in self._pools.values()
                   if p.states)

    def submit(self, a, b=None, x0=None, *, tol: Optional[float] = None,
               maxiter: Optional[int] = None, policy: Optional[str] = None,
               scheme: Optional[str] = None) -> int:
        """Admit one SPD system; returns the request id.  ``policy`` /
        ``scheme`` route it to the matching (scheme, policy) pool.  With
        ``cfg.escalate_fp64`` the operands are retained so a breakdown
        exit can be retried once in the ``cfg.escalate_scheme`` pool."""
        rid = self._next_id
        m = self._metrics
        with m.span("submit", rid=rid):
            # a lane done since the last tick frees its slot
            with m.span("submit.harvest"):
                self._harvest()
            pool = self._pool(scheme, policy)
            s = pool.admit(a, b, x0, tol, maxiter)
            self._next_id += 1
            pool.req_of_slot[s] = rid
            if self.cfg.escalate_fp64:
                self._meta[rid] = (a, b, x0, tol, maxiter,
                                   self.cfg.policy if policy is None
                                   else policy)
        return rid

    def step(self) -> Dict[int, CGResult]:
        """One chunked tick (≤ ``chunk_iters`` iterations for every live
        lane in every pool); harvests and frees finished slots, returning
        ``{request_id: CGResult}``."""
        m = self._metrics
        with m.span("step"):
            for pool in self._pools.values():
                if pool.any_active:
                    pool.step()
            with m.span("step.harvest"):
                done = self._harvest()
            with m.span("step.compact"):
                for pool in self._pools.values():
                    pool.maybe_compact()
        return done

    def _harvest(self) -> Dict[int, CGResult]:
        raw: Dict[int, CGResult] = {}
        for pool in self._pools.values():
            raw.update(pool.harvest())
        done: Dict[int, CGResult] = {}
        for rid, res in raw.items():
            if self._should_escalate(rid, res):
                # One retry at the escalation scheme under the SAME
                # request id: the caller sees one (final) result.
                a, b, x0, tol, maxiter, policy = self._meta[rid]
                pool = self._pool(self.cfg.escalate_scheme, policy)
                s = pool.admit(a, b, x0, tol, maxiter)
                pool.req_of_slot[s] = rid
                self._retried.add(rid)
                self._metrics.bump("escalations")
                continue
            res.retried = rid in self._retried
            self._metrics.record_exit(res.status)
            self._meta.pop(rid, None)
            self._retried.discard(rid)
            done[rid] = res
        self.results.update(done)
        return done

    def _should_escalate(self, rid: int, res: CGResult) -> bool:
        if not (self.cfg.escalate_fp64 and is_breakdown(res.status)):
            return False
        if rid in self._retried or rid not in self._meta:
            return False
        return res.scheme != get_scheme(self.cfg.escalate_scheme).name

    def run_to_completion(self, max_ticks: int = 10_000
                          ) -> Dict[int, CGResult]:
        """Tick until every admitted system finished; returns all results
        harvested during the call.  Raises if ``max_ticks`` elapses with
        lanes still live."""
        out: Dict[int, CGResult] = {}
        out.update(self._harvest())
        ticks = 0
        while any(p.any_active for p in self._pools.values()):
            if ticks >= max_ticks:
                live = [rid for p in self._pools.values()
                        for rid, on in zip(p.req_of_slot, p.active_lanes())
                        if rid is not None and on]
                raise RuntimeError(
                    f"run_to_completion hit max_ticks={max_ticks} with "
                    f"requests {live} still active (chunk_iters="
                    f"{self.cfg.chunk_iters}); raise max_ticks or maxiter")
            out.update(self.step())
            ticks += 1
        return out
