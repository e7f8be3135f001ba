#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py        # full size, phases 0-15 (6b, 6c); no options

0. The build: every kernel's registers, stack frame and spills from the
   ptxas report; each ELLPACK instantiation with a register tree
   (``next_pow2(E) ≤ 32``) and each SELL register-tree instantiation
   (``spmv_sell_kernel<…, false>``, all 14: 7 type triples, the TPU
   tier's bf16 ones included, × int16/int32) must have a 0-byte stack
   frame (SELL: and no spills), each bf16 ``flash_attention``
   instantiation no spills: the ``mma_sync`` ones (``flash_fwd_bf16``)
   ``HMMA`` in their SASS, the ``wgmma`` ones (``flash_fwd_sm90``, 3 head
   dims × 2 output dtypes) no stack frame and ``HGMMA`` and ``UTMALDG``
   (TMA loads) in theirs; each fp32 ``tf32x3`` one
   (``flash_fwd_tf32``, 3 head dims) no stack frame and no spills, and
   ``HGMMA`` and ``UBLKCP`` (its bulk copies) in its SASS; each
   ``dot3_bulk`` instantiation bulk copies (``UBLKCP``) and mbarrier
   operations (``SYNCS``) in its SASS.
1. Kernels against their plain PyTorch versions on the card: the SELL
   kernel with each bag's per-lane table (the main bag, an int16 bag,
   lanes whose widths differ ~30×, and 2,049-slot hub rows for its
   generic tree) and in row-ELL form (one group, the shared table), bit
   for bit; the ELLPACK kernel (on Poisson lanes, and on banded bags
   whose slab width E takes every tree instantiation: 1, 2, 7, 12, 20,
   and 40 for the generic tree), bitwise; every faithful scheme and
   every TPU-tier scheme (``tpu_fp32``, bf16 ``tpu_v1..v3``), int16 and
   int32 indices.  Times each kernel, its plain version and a
   block-diagonal CSR ``torch.sparse.mm`` of the same bag (a yardstick
   only, never called by the port: fp64 for the kernels at mixed_v3, SELL
   also at fp64; at the tier's value dtype for each tier entry, "none"
   where PyTorch has no such call), beside bounds at 3.35 TB/s (the
   tier's at its own bytes: 2 B bf16 values): ``bound_ms`` for the bag's
   nonzeros at their at-rest widths, ``bound_stored_ms`` for every stored
   slot of the padded layout and, for SELL, ``bound_streamed_ms`` for the
   slots below each lane's own width (what it reads), with the slots
   streamed beside those stored and the kernel on each lane class alone.
2. The batched solve (``jpcg_solve_batched``) at full size — a bag of
   G = 8 lanes from the large tier of the paper's Table 3 classes (n up to
   250,000, n_pad 262,144): VM ≡ phases bitwise under mixed_v3 (SELL) and
   fp64, and the ELLPACK and row-ELL layouts on the Poisson lanes; every
   lane CONVERGED with a true residual ‖Ax−b‖/‖b‖ ≤ 1e-6 on the host in
   fp64.  On the mixed_v3 SELL bag the generic VM (``specialize=False``,
   the program an operand) ≡ the specialized VM ≡ phases, bit for bit.
   The tier: the bag at ``tpu_v3`` (SELL; row-ELL on the Poisson lanes),
   VM ≡ phases bitwise, to ‖r‖ ≤ 1e-5 ‖b‖ (``TIER_RTOL``, a level fp32
   vectors reach), every lane CONVERGED, its status and true residual
   logged (bf16 values: the true residual is of A, not of the bf16 A the
   tier solves); then every tier scheme through row-ELL and ELLPACK on
   the Poisson lanes once.  Each VM loop is timed alone on pre-packed
   operands; the mixed_v3 SELL loop (specialized and generic), the
   ELLPACK loop and the ``tpu_v3`` SELL loop are profiled (device time
   by kernel, busy share).
3. ``SolverEngine``: ~10 requests of mixed sizes plus one singular lane;
   the singular lane exits BREAKDOWN_INDEFINITE at iteration 0, the rest
   converge, ``bytes_streamed_est`` equals the packed-array accounting.
   Then one ``SolverEngine(specialize=False)`` serves ``poisson_2d(500)``
   and a power-law lane under the paper and the min-traffic policies
   through one cached generic stepper, the two policies bit for bit.
4. The same small bag through the port on the card and on the CPU.
5. The single-system kernels against their plain versions on the card,
   bitwise: ``spmv_ell`` (the ELLPACK kernel at G = 1) on
   ``poisson_2d(1000)`` and on the banded widths of phase 1 for every
   faithful and tier scheme; ``dot`` (one launch) at n ∈ {1, 2047, 2048, 2049,
   10^6} and three calls in a row of different n; ``dot3`` (one
   launch, a block per chunk reading through bulk copies) at the same n, 10^7
   (fp64) and 2^24 + 2,049 (fp32), three calls in a row, one call on each
   of two streams at once, r, u and w one to three elements into their
   storage, and one kernel a call in the profiler, each bit for bit; it is
   timed at n = 10^6 (fp64, fp32) and 10^7 (fp64) beside its bound and
   three ``torch.dot`` calls; ``dot``, ``dot3``,
   ``phase2`` and ``phase3`` at fp32 and fp64 on vectors of n = 10^6 and
   of ragged lengths.  Each is timed at n = 10^6 (fp64; the SpMV at
   mixed_v3, and each tier scheme) with a cold, clean L2 before every
   call, beside its plain version, its bound at 3.35 TB/s and, where one
   PyTorch call computes the same function, that call (``torch.dot``; a
   CSR ``torch.sparse.mm`` for the SpMV, fp64 or at the tier's value
   dtype).
5b. The CSR-to-ELLPACK packer (``kernels/pack``, both passes) against its
   plain version, bit for bit: Poisson, scrambled (unsorted, duplicated
   columns), emptied-row and zero-nonzero matrices at block_rows/col_tile
   32/64 and 256/512, every faithful and tier scheme, at the matrix's own
   dims and a bucket past them, into lanes filled with stale values; then
   ``poisson_2d(1000)`` (ecology2's shape) at mixed_v3 into the engine's
   bucket and at its own dims, repeated bit for bit, both passes timed in
   the profiler with a cold L2 beside their bound (the CSR read once and
   the lane written once at 3.35 TB/s) and the plain version on the card.
6. The single-system solve (``jpcg_solve``) at full size on
   ``poisson_2d(1000)`` (n = 1,000,000, 4,996,000 nonzeros; b = 1,
   x0 = 0, tol 1e-12, maxiter 20,000): ``vsr`` × ``pallas`` at mixed_v3
   and fp64, ``vsr`` × ``xla`` and ``pipelined`` × ``xla`` at mixed_v3,
   and ``vsr`` × ``pallas`` at ``tpu_v3`` to ‖r‖ ≤ 1e-5 ‖b‖ (its launches
   counted as the mixed_v3 run's, ``spmv_ell[tpu_v3]`` too; its true
   residual logged).  Every faithful solve converges to a true residual
   ≤ 1e-6; every solve repeated from a pre-built operator gives the same
   iterations and x bit for bit; at mixed_v3 the
   ``pallas`` and ``xla`` VSR solves agree (iterations ±1, x within
   rtol 1e-4, atol 1e-6) and the pipelined x agrees with them.  Each is
   timed as a call from the CSR and as the loop alone on a pre-built
   operator; the mixed_v3 ``pallas`` loop is profiled once.
6b. Lane sharding: ``jpcg_solve_batched(mesh=)`` on the G = 8 bag
   (mixed_v3, SELL) over ``lane_mesh()`` (every visible card; D = 1 on a
   one-card machine) and over ``(cuda:0, cuda:0)`` (D = 2, both shards on
   the one card), each held bit for bit against phase 2's unsharded solve
   (x, rr, iterations, statuses); each loop timed alone on operands packed
   once on the host and cut per mesh, and profiled (ms/tick, kernels a
   tick, busy share).  A D = 2 ``SolverEngine`` on the four Poisson lanes
   through ELLPACK is held bit for bit against the unsharded engine.  A
   record beside it: how many of 8 rows' bits CUDA's plain ``sum(-1)``
   changes between G = 8 and 2 × G = 4; and a check that the staged row
   dot of the batched loop changes none between G = 8 and G = 4, 2, 1, at
   n up to 8,388,611, fp64 and fp32.
6c. The row-distributed CG (``repro_torch.distributed.make_dist_solver``)
   on a world-size-1 NCCL group (``file://`` rendezvous in a temporary
   directory, destroyed after): ``poisson_2d(1000)``, mixed_v3, ``vsr``
   and ``pipelined``, ``comm="allgather"`` (one shard has no neighbour,
   so no halo); rr ≤ 1e-12 and a true residual ≤ 1e-6; ``vsr`` within ±1
   iteration of phase 6's ``vsr`` × ``xla`` and max |Δx| ≤ 1e-9 · max |x|,
   ``pipelined`` within ±2 of phase 6's ``pipelined`` × ``xla`` and x
   within rtol 1e-4, atol 1e-6; a second solve repeats every bit; 2
   all-reduces an iteration for ``vsr``, 1 for ``pipelined``; timed and
   profiled.
7. ``flash_attention`` against its plain version on the card, within a
   stated tolerance (not bitwise: the kernel sums the softmax over K tiles
   in its own order): gemma3-1b's attention shapes (BH = 8, S = T = 4,096,
   D = 256; causal and window 512; bf16 and fp32) and the reference test's
   small cases (D = 16/20/32/64/120, S ≠ T, ×30 logits), llama4-scout's
   D = 128, the ``wgmma`` kernel's edges in bf16 (ragged S and T, T
   below one tile, D 8/16/32/136 between its instantiations, windows),
   fp32 D = 36 (``tf32x3`` padding D to 64) and D = 42 and views one
   element off a 16-byte boundary (which ``tf32x3`` does not take), each
   on the route ``flash_attn._route`` picks, read from the route's launch
   count: every bf16 case with D % 8 = 0 ``wgmma``
   (``csrc/flash_attn_sm90.cu``), d20 ``mma_sync`` (``csrc/flash_attn.cu``),
   every fp32 case with D % 4 = 0 and D > 32 ``tf32x3``
   (``csrc/flash_attn_tf32.cu``), the rest ``fp32`` (the CUDA-core kernel,
   ``csrc/flash_attn.cu``: D ≤ 32, ``_route``'s carve-out for the
   reference test's ×30 logits, d42 and the offset views).  A bf16 output is held to one bf16 ulp of the
   plain version's; the bf16 kernel's fp32 output before rounding (a
   private entry: bf16 in, fp32 out) is held to the plain version on the
   widened inputs within the fp32 tolerance of the shape.  The bf16 shapes
   of the main path (gemma's two and the prefill_32k shape per sequence,
   BH = 4, S = 32,768, global and window 512) are also held on the
   ``mma_sync`` kernel (a forced route) and both kernels timed in turns,
   beside the plain version, ``scaled_dot_product_attention`` (the library
   yardstick, never called by the port), the bound (bf16: q·k once and p·v
   twice — p carried to 16 bits as two bf16 passes — at the bf16
   tensor-core peak; ``tf32x3``: both products as three TF32 products each
   at the TF32 tensor-core peak; the CUDA-core kernel: both products at
   the fp32 CUDA-core peak; bytes: q, k, v read and o written once) and,
   logged apart, the exponential floor (one exponential a live pair at
   3.9e12 a second); gemma's fp32 shapes likewise on both fp32 kernels
   (``tf32x3`` and, forced, the CUDA-core one: held, timed in turns,
   each beside its own bound; ``tf32x3``'s pre-pass, its scratch bytes and
   its profiled time logged beside the bound, not in it).  A time under
   95 % of its bound (a share over 105 %) fails.
8. gemma3-1b at full width, its depth cut to 6 of 26 layers (5 local and
   the first global one; 463,026,816 fp32 parameters drawn on the card
   from a seeded generator): ``forward_logits(last_only=True)`` at B = 1,
   S = 8,192 (the Q-chunked attention), bf16, timed; then the kernel
   composed into layers 0 (local) and 5 (global) — dense → RoPE → kv
   heads repeated → ``flash_attention`` → ``wo`` — against the model's
   ``attention()`` on S = 4,096 normalized hidden states, B = 2, within
   2e-4 at fp32 and 3e-2 at bf16.
9. ``DecodeEngine`` on gemma3-1b (6 layers): bf16, 8 slots, max_len
   1,024; 10 greedy requests of 8–64 tokens and one of 600 (the 512-slot
   ring wraps), 32 new tokens each, admitted as slots free.  Prefill
   ms/token, ms/tick, tokens/s and the tick's device-busy share
   (``torch.profiler``: device time over the wall time of 8 profiled
   ticks).  Then at fp32: a greedy continuation equals the teacher-forced
   rollout of ``forward_logits`` and the 600-token request's first token
   equals ``forward``'s argmax; the bf16 tokens' agreement with fp32 is
   printed as a rate.
10. Training gemma3-1b at full width and 6 layers (463,026,816 random
   fp32 parameters, bf16 compute, ``remat``; ``SyntheticLM`` Markov data, B = 8, S = 128),
   after the serving engine is freed: a ``Trainer`` with AdamW (bf16
   moments) for 4 steps, checkpointed at step 2 (3.7 GB, npz + sha256)
   and resumed into other parameters, whose steps 2–3 give the same
   losses and every parameter the same bits as the uninterrupted run's;
   the loss and gradients of 2 strided microbatches within rel 1e-3 and
   ‖Δ‖ ≤ 3e-2 ‖g‖ of the full batch's, and one ``microbatches=2`` step;
   2 CGGN steps through ``launch/train.cggn_lm_step`` (cg_iters 8, 4
   probes, ``tpu_fp32``; the first refreshes the diagonal), every metric
   finite and ‖δ‖ ≤ ``max_delta_norm``, the inner CG's iterations
   printed; a GGN matvec timed alone.  ms/step and tokens/s, ms per CGGN
   step and per matvec, ``max_memory_allocated`` for each optimizer, and
   the device-busy share (``torch.profiler``) of one AdamW step and one
   matvec.  No kernel is on this path (the reference's training path
   reaches no Pallas kernel): its launch counts stay 0.
10b. The sharded train step: a (1, 1) ``("data", "model")`` mesh
   (``repro_torch.launch.mesh.make_mesh``) over a world-size-1 NCCL group
   (``file://`` rendezvous, as phase 6c), gemma3-1b at phase 10's width,
   6 layers, B = 8, S = 128, batch and seed-0 weights: two
   ``make_train_step(cfg, mesh)`` steps (DTensor parameters and AdamW
   moments by ``distributed.sharding.param_specs``) against two unsharded
   steps, the loss, every parameter and both moments bit for bit; the
   sharded state checkpointed (payload sha256 equal to an unsharded
   save's) and restored unsharded and through
   ``train.fault.elastic_restore`` onto the (1, 1) mesh, bit for bit.
   ms/step sharded against unsharded, kernels a step and the busy share
   (``torch.profiler``), peak memory, beside the card's name and power
   limit.  No kernel is on this path: its launch counts stay 0.
11. The MoE, SSM and hybrid families at full width, after phase 10 frees
   its memory: granite-moe-1b-a400m (1,334,628,352 parameters),
   mamba2-780m (780,148,992) and zamba2-1.2b (1,104,937,856), random
   fp32 parameters drawn on the card from a seeded generator, bf16
   compute.  Each: ``forward_logits(last_only=True)`` at B = 1, S = 8,192
   (granite: 8 routing groups, capacity 320), timed; ``DecodeEngine``
   (bf16, 8 slots, max_len 1,024) over 10 greedy requests of 8–64 tokens,
   16 new tokens each (two slots reused): prefill ms/token, ms/tick,
   tokens/s and the busy share of 8 profiled ticks; at fp32 a fresh
   slot's greedy continuation of a 16-token prompt equals the
   teacher-forced rollout of ``forward_logits`` (granite at ``capacity_factor`` E/K = 4, so no pick
   is dropped in either grouping); a ``Trainer`` with AdamW (bf16
   moments, lr 3e-3 from step 0) for 3 steps on one batch of B = 8,
   S = 128: losses finite and falling or within 1 % of step 0's, ms/step,
   tokens/s, peak memory, the busy share of one step.  The SSMs also: the
   gradients finite at S = 128 (SSD chunk 128, where the reference's
   backward gives NaN); a reused slot's prefill logits (16 tokens) from
   its stale state differ from a fresh slot's (the reference's behaviour); the SSM
   cache bytes per slot the same at max_len 1,024 and 8,192.
   ``flash_attention`` composed into granite's layer 0 (D = 64, GQA 16:8)
   and zamba2's shared block (D = 64, 32:32), S = 4,096, B = 2, against
   ``attention()`` within 2e-4 at fp32 and 3e-2 at bf16 (these launches
   count on the path: ``wgmma`` at bf16, ``tf32x3`` at fp32); after
   the count is read, the kernel alone at those shapes (causal) held and
   timed on both bf16 kernels and on both fp32 kernels as in phase 7.  Then
   llama4-scout-17b-a16e at full
   width with its depth cut to 2 of 48 layers (5.2 B parameters; 48 do
   not fit one card):
   ``forward_logits(last_only)`` at S = 4,096 and 4 decode ticks (top-1 of
   16 experts, d = 5,120, capacity 80 a group).
12. The encoder-decoder family and the int8 KV cache: whisper-base at full
   width (70,686,208 random fp32 parameters drawn on the card from a
   seeded generator, bf16 compute, 1,500 frames of seeded random audio
   embeddings a row).  ``forward_logits(last_only)`` at B = 8, S = 4,096
   and at B = 1, S = 32,768 (the Q-chunked path): time, tokens/s, peak
   memory.  ``flash_attention`` composed into encoder layer 0
   (non-causal, S = T = 1,500, BH 64, D 64: a ragged last 64-key tile)
   and into decoder layer 0's cross attention (S 4,096, T 1,500) against
   ``attention(cross_kv=)`` within 2e-4 at fp32 and 3e-2 at bf16 (these
   launches count on the path: ``wgmma`` at bf16, ``tf32x3`` at fp32);
   after the count is read, the kernel alone at both shapes (non-causal)
   held and timed on both bf16 kernels and on both fp32 kernels as in
   phase 7 (S·T live pairs).
   ``DecodeEngine`` (bf16, 8 slots, max_len 1,024) over 10 greedy
   requests of 8–64 tokens with their own audio, 16 new tokens each (two
   slots reused): prefill ms/token (encode and ``prefill_cross``
   included), ms/tick, decode tokens/s, the busy share of 8 profiled
   ticks, cache bytes a slot (self and cross); at fp32 a fresh slot's
   greedy continuation of a 16-token prompt equals the teacher-forced
   rollout of ``forward_logits`` with the same audio.  A ``Trainer``
   with AdamW (bf16 moments, lr 3e-3 from step 0) for 3 steps on one
   batch of B = 8, S = 448 with audio (losses finite and falling or
   within 1 % of step 0's; ms/step, tokens/s, peak memory, busy share),
   then 2 CGGN steps through ``cggn_lm_step`` on it, every metric finite.
   The int8 KV cache at gemma3-1b's global-layer shape (H 4, Hk 1, hd
   256; B 8, 32,768 positions): ``attn_decode_quant`` against
   ``attn_decode`` at bf16 within max |Δ| / max |y| < 0.05, cache bytes
   under 0.6× bf16's, ms a decode call of each.
13. The paper's Tables 4, 5 and 7 on the card: ``benchmark_suite("all")``
   (the 12 synthetic stand-ins for Table 3's classes, n up to 10^6)
   through ``jpcg_solve(method="vsr", backend="pallas")`` (``spmv_ell``,
   ``phase2``, ``phase3``, ``dot``) at tol 1e-12, maxiter 20,000, at fp64
   and mixed_v3 on every matrix and at mixed_v2 and mixed_v1 on the small
   tier (logged with their statuses, not gated).  Every fp64 and mixed_v3
   solve converges to a true residual ≤ 1e-6 on the host in fp64, repeats
   bit for bit from a pre-built operator, and on the small tier agrees
   with ``xla`` (iterations ±1, x within rtol 1e-4, atol 1e-6).  Logged
   for each: iterations and their difference from fp64 (Table 7), call
   wall and loop alone (Table 4), ms an iteration and GFLOP/s by the
   paper's count, 2·nnz + 13·n (Table 5), the loop's share of its
   analytic bound an iteration (``roofline.solver_terms``: the
   min-traffic schedule's 13 vector accesses and a value and index a
   nonzero, over 3.35 TB/s) and of the ELLPACK operand's stored-slot
   bound (``EllpackMatrix.stream_bytes``), each ≤ 105 %.
14. Roofline terms of the LM cells measured above (``roofline``, H100
   peaks, bf16): gemma3-1b's prefill, engine tick and AdamW step,
   granite-moe's, mamba2's and zamba2's prefill and AdamW step, and
   whisper's prefill at B 8 × S 4,096.  Each is counted once with
   ``count_torch`` (every dispatched ATen op: flops, bytes, collective
   bytes) outside its phase's timed windows, at the phase's shapes, and
   priced beside the time its phase measured: flops and bytes > 0, the
   bound over the measured time ≤ 105 %, the useful fraction (model
   flops, 6·N·D, 2·N·B·S or 2·N·B with N the active parameters, over
   counted flops) and MFU at the measured time.
15. The four examples of ``examples_torch/`` through their ``main``,
   in-process on ``cuda:0``: ``quickstart``, ``solve_poisson`` at its
   default ``n_side`` of 48, profiled (its ``backend="pallas"`` solve
   launches ``spmv_ell``, ``phase2``, ``phase3`` and ``dot``, its VM
   solves ``spmv_sell``; each of the first four seen by
   ``torch.profiler`` as often as its wrapper counted it, within 10 %),
   ``serve_decode`` and ``train_lm_cggn --size 25m`` at 100 AdamW and 10
   CGGN steps; then
   ``quickstart``, ``solve_poisson`` and ``serve_decode`` with ``--device
   cpu`` on the host.  Every solve CONVERGED on both devices with the same
   iterations (``pipelined`` ±2, the VM ±1, the plain ``xla`` SpMV at
   mixed_v1 ±10 %: ``_example_slack``), the same decode token counts,
   and the loss falling under both optimizers; the phase's wall time
   printed beside the card's name and power limit.

Launch counters are set to 0 right before the solves of phases 2, 3, 6,
6b and 6c and before phases 8, 10, 11, 12, 13 and 15, and read right
after; each kernel of a path must have launched on it (6b: ``spmv_sell`` and ``spmv_ellpack``; 6c runs
the reference's plain banked-ELL product, no kernel; ``dot3`` has no
solver path: phase 5 launches it; nor have ``spmv_ell`` at
``tpu_fp32``/``tpu_v1``/``tpu_v2``).  A tier
instantiation counts under its kernel's name and, apart, under
``<kernel>[<scheme>]``, and a ``flash_attention`` launch under
``flash_attention[<route>]`` (``wgmma``, ``mma_sync``, ``tf32x3``,
``fp32``; the LM paths must launch ``wgmma`` and ``tf32x3`` and never
``fp32``, and no model takes ``mma_sync``); the ``kernels`` line lists
each such entry.
No path is cut in depth but two LM ones: gemma3-1b's (6 of 26 layers,
phases 8-10, so that phase 11 fits the time limit) and llama4-scout's (2
of 48, phase 11: 48 do not fit one card); phase 15 runs
``train_lm_cggn``'s 25m model at 100 AdamW and 10 CGGN steps (the
script's defaults are 200 and 20).
Any failed check raises, and so does any kernel's time under 95 % of its
bound.  The last line is the JSON result; before the card's line come the
sharded and distributed phases' numbers, then the LM path's, the
training path's, the families', whisper's, the suite's, the roofline's
and the examples'.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SCHEMES = ("fp64", "mixed_v1", "mixed_v2", "mixed_v3")
#: the TPU tier (one level down: bf16 values, fp32 vectors); tpu_fp32 runs
#: mixed_v1's instantiation, tpu_v1..v3 the bf16 ones
TIER = ("tpu_fp32", "tpu_v1", "tpu_v2", "tpu_v3")
SOLVE_TOL = 1e-12
RESIDUAL_MAX = 1e-6
#: the tier's solves stop at ‖r‖ ≤ 1e-5 ‖b‖ (rr ≤ 1e-10 ‖b‖²), a level
#: fp32 vectors reach; 1e-12 absolute is below fp32's resolution of rr
TIER_RTOL = 1e-5
#: a kernel faster than its bound allows means a wrong bound or timing
SHARE_MAX = 1.05


_START = time.perf_counter()


def log(*args):
    print(*args, flush=True)


def log_phase(title: str):
    """A phase's header, with the seconds since the script started."""
    log(f"{title} [{time.perf_counter() - _START:.0f} s]")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- phase 0
def _demangle(names):
    """Kernel names without return type, anonymous namespace and the
    argument list."""
    tool = shutil.which("c++filt")
    if tool and names:
        out = subprocess.run([tool], input="\n".join(names),
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout.splitlines()
    else:
        out = list(names)
    short = []
    for name in out:
        name = name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0]
        short.append(name[5:] if name.startswith("void ") else name)
    return dict(zip(names, short))


def ptxas_report(source: str) -> dict:
    """``{kernel: {registers, stack, spill_stores, spill_loads}}`` from one
    source's build log (``nvcc -Xptxas -v``)."""
    from repro_torch.kernels import _build
    rows, cur = {}, None
    for line in _build.build_log(source).splitlines():
        m = (re.search(r"Compiling entry function '(\S+)'", line)
             or re.search(r"Function properties for (\S+)", line))
        if m:
            cur = m.group(1)
            rows.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            rows[cur].update(stack=int(m[1]), spill_stores=int(m[2]),
                             spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            rows[cur]["registers"] = int(m[1])
        m = re.search(r"(\d+) bytes smem", line)
        if m and cur:
            rows[cur]["smem"] = int(m[1])
    names = _demangle(list(rows))
    return {names[k]: v for k, v in rows.items()}


def sass_counts(lib: Path, opcode: str):
    """``{kernel: count of opcode in its SASS}`` (``cuobjdump -sass``), or
    None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur and re.search(rf"\b{opcode}\b", line):
            counts[cur] += 1
    names = _demangle(list(counts))
    return {names[k]: v for k, v in counts.items()}


def phase_build(libs: dict) -> None:
    """Log every kernel's ptxas report; each ELLPACK register-tree
    instantiation must keep a 0-byte stack frame, each SELL register-tree
    instantiation a 0-byte stack frame and no spills, each bf16 flash
    instantiation must not spill (the wgmma ones: nor keep a stack frame),
    and must run HMMA (mma_sync) or HGMMA and UTMALDG (wgmma), each fp32
    tf32x3 one must keep no stack frame, not spill and run HGMMA and bulk
    copies, and each dot3 instantiation must run bulk copies and mbarrier
    operations."""
    faults = []
    sell = 0
    for source in ("spmv_sell", "spmv_ellpack", "dot", "fused_phase",
                   "flash_attn", "flash_attn_sm90", "flash_attn_tf32",
                   "ellpack_pack"):
        for kern, r in ptxas_report(source).items():
            sell += kern.startswith("spmv_sell_kernel<")
            log(f"  {source}: {kern}: {r.get('registers')} registers, "
                f"{r.get('stack')} B stack, {r.get('spill_stores')} / "
                f"{r.get('spill_loads')} B spill stores / loads, "
                f"{r.get('smem', 0)} B static shared")
            if kern.startswith("spmv_ellpack_reg<") and r.get("stack") != 0:
                faults.append(f"{kern}: {r.get('stack')} B stack frame")
            # the SELL kernel's register-tree instantiations (kWide false)
            if kern.startswith("spmv_sell_kernel<") and kern.endswith(
                    "false>") and (r.get("stack") or r.get("spill_stores")
                                   or r.get("spill_loads")):
                faults.append(f"{kern}: stack / spills {r}")
            if kern.startswith(("flash_fwd_bf16<", "flash_fwd_sm90<",
                                "flash_fwd_tf32<")) and (
                    r.get("spill_stores") or r.get("spill_loads")):
                faults.append(f"{kern} spills: {r}")
            if kern.startswith(("flash_fwd_sm90<", "flash_fwd_tf32<")) and \
                    r.get("stack"):
                faults.append(f"{kern}: {r.get('stack')} B stack frame")
    if sell != 28:
        faults.append(f"{sell} spmv_sell_kernel instantiations in the ptxas "
                      "report, not 28 (7 type triples × 2 index widths × 2 "
                      "trees)")
    faults += flash_sass(libs)
    faults += dot3_build(libs)
    if faults:
        raise AssertionError("build: " + "; ".join(faults))


def flash_sass(libs: dict) -> list:
    """The flash kernels' tensor-core instructions in their SASS: ``HMMA``
    in each ``mma_sync`` instantiation (``flash_fwd_bf16``), ``HGMMA``
    (wgmma) and ``UTMALDG`` (TMA loads) in each ``wgmma`` one
    (``flash_fwd_sm90``; 3 head dims × 2 output dtypes), ``HGMMA`` and
    ``UBLKCP`` (bulk copies) in each ``tf32x3`` one (``flash_fwd_tf32``;
    3 head dims).  Returns the faults."""
    hmma = sass_counts(libs["flash_attn"], "HMMA")
    if hmma is None:
        log("  flash_attn: no cuobjdump in the toolkit; SASS not checked")
        return []
    faults = []
    bf16 = {k: c for k, c in hmma.items() if k.startswith("flash_fwd_bf16<")}
    log(f"  flash_attn SASS: HMMA per bf16 instantiation {bf16}")
    if not bf16 or not all(bf16.values()):
        faults.append(f"flash_fwd_bf16 without HMMA: {bf16}")
    counts = {op: sass_counts(libs["flash_attn_sm90"], op)
              for op in ("HGMMA", "UTMALDG")}
    sm90 = {k: {op: c[k] for op, c in counts.items()}
            for k in counts["HGMMA"] if k.startswith("flash_fwd_sm90<")}
    log(f"  flash_attn_sm90 SASS: HGMMA and UTMALDG per instantiation "
        f"{sm90}")
    if len(sm90) != 6 or not all(all(c.values()) for c in sm90.values()):
        faults.append(f"flash_fwd_sm90 without HGMMA or UTMALDG: {sm90}")
    counts = {op: sass_counts(libs["flash_attn_tf32"], op)
              for op in ("HGMMA", "UBLKCP")}
    tf32 = {k: {op: c[k] for op, c in counts.items()}
            for k in counts["HGMMA"] if k.startswith("flash_fwd_tf32<")}
    log(f"  flash_attn_tf32 SASS: HGMMA and UBLKCP per instantiation {tf32}")
    if len(tf32) != 3 or not all(all(c.values()) for c in tf32.values()):
        faults.append(f"flash_fwd_tf32 without HGMMA or UBLKCP: {tf32}")
    return faults


def dot3_build(libs: dict) -> list:
    """dot3's bulk copies (``UBLKCP``) and mbarrier operations (``SYNCS``)
    in the SASS of each instantiation.  Returns the faults."""
    counts = {op: sass_counts(libs["dot"], op) for op in ("UBLKCP", "SYNCS")}
    if counts["UBLKCP"] is None:
        log("  dot: no cuobjdump in the toolkit; UBLKCP not checked")
        return []
    bulk = {k: {op: c[k] for op, c in counts.items()}
            for k in counts["UBLKCP"] if k.startswith("dot3_bulk<")}
    log(f"  dot SASS: bulk copies and mbarrier operations per dot3 "
        f"instantiation {bulk}")
    if len(bulk) != 2 or not all(all(c.values()) for c in bulk.values()):
        return [f"dot3_bulk without UBLKCP or SYNCS: {bulk}"]
    return []


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


#: the smoke bag's lane classes (name, first lane, end)
BAG_CLASSES = (("poisson_2d(500)", 0, 4), ("diag_dominant_spd, 70 a row", 4, 6),
               ("powerlaw_spd", 6, 8))


def int16_bag():
    """A bag whose bucketed rows stay under 2^15: int16 indices."""
    from repro_torch.sparse import diag_dominant_spd, poisson_2d, powerlaw_spd
    return [poisson_2d(120), diag_dominant_spd(16000, nnz_per_row=30,
                                               dominance=1.1, seed=3),
            powerlaw_spd(16384, alpha=2.1, max_deg=512, seed=7)]


#: ELLPACK slab widths E for the bitwise cases: register trees of every
#: padded width 1, 2, 8, 16, 32 (7, 12, 20 are not powers of two), and
#: 40 for the generic tree
ELL_WIDTHS = (1, 2, 7, 12, 20, 40)


def banded(n, w, seed):
    """Row i's w nonzeros at columns i .. i + w − 1 (clipped to n), values
    from a seed: inside one 512-column tile a row's slab has w slots."""
    import numpy as np
    from repro_torch.sparse import csr_from_coo
    i = np.repeat(np.arange(n), w)
    j = i + np.tile(np.arange(w), n)
    keep = j < n
    vals = np.random.default_rng(seed).standard_normal(int(keep.sum()))
    return csr_from_coo(i[keep], j[keep], vals, (n, n))


def width_bag(w):
    """Two banded lanes whose stacked slab width E is w."""
    return [banded(3000, w, w), banded(1200, max(1, w // 2), w + 1)]


def wide_bag():
    """Lanes whose widths differ ~30×: 5-wide stencil rows stored in
    slices padded to a ~160-wide random lane's width."""
    from repro_torch.sparse import diag_dominant_spd, poisson_2d
    return [poisson_2d(300), diag_dominant_spd(40000, nnz_per_row=160,
                                               dominance=1.1, seed=21),
            poisson_2d(200)]


def hub_bag():
    """64 rows of 2,049 slots (4,096 leaves: 128 a thread, the SELL
    kernel's generic-tree instantiation) beside a stencil lane."""
    import numpy as np
    from repro_torch.sparse import csr_from_coo, poisson_2d
    n, hubs, w = 4096, 64, 2049
    i = np.concatenate([np.repeat(np.arange(hubs), w), np.arange(n)])
    j = np.concatenate([(np.repeat(np.arange(hubs), w)
                         + np.tile(np.arange(w), hubs)) % n, np.arange(n)])
    vals = np.random.default_rng(31).standard_normal(i.size)
    return [csr_from_coo(i, j, vals, (n, n)), poisson_2d(64)]


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


def median_ms(fn, reps: int = 20, windows: int = 3) -> float:
    """The median of ``windows`` :func:`cuda_ms` runs: a host stall that
    leaves the card idle inside one window does not set the time."""
    return sorted(cuda_ms(fn, reps=reps) for _ in range(windows))[
        windows // 2]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(bytes_moved: int, flops: int, acc_dtype) -> tuple:
    """The card's peaks are ``repro_torch.roofline.model.H100``'s (the
    H100 SXM5 data sheet, dense): fp64 and fp32 off the tensor cores, bf16
    on them (the tier's SpMVs are bound by bytes either way)."""
    from repro_torch.roofline.model import H100
    t_bytes = bytes_moved / H100.hbm_bw * 1e3
    t_ops = flops / H100.peak_flops(str(acc_dtype)) * 1e3
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


def _bits(a, b) -> bool:
    """Bit for bit, the sign of a zero included."""
    import torch
    ints = {torch.float64: torch.int64, torch.float32: torch.int32,
            torch.bfloat16: torch.int16}
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def library_ms(A64, x, dtype, timer=None):
    """The library yardstick at a value dtype: ``torch.sparse.mm`` of the
    CSR ``A64`` cast to ``dtype`` by ``x`` at ``dtype``; None where PyTorch
    has no such call on the card (it raises)."""
    import torch
    timer = timer or cuda_ms
    try:
        A = A64.to(dtype)
        xs = x.to(dtype)
        torch.sparse.mm(A, xs)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"    no torch.sparse.mm at {dtype}: {str(e).splitlines()[0][:100]}")
        return None
    return timer(lambda: torch.sparse.mm(A, xs))


def phase_kernels(bag, dev):
    """Every kernel against its plain version on the card, bitwise (SELL
    and row-ELL bit for bit, zero signs included), at the faithful schemes
    and the TPU tier."""
    import torch
    from repro_torch.core.batch import stack_operands
    from repro_torch.core.precision import get_scheme
    from repro_torch.kernels import spmv as K

    gen = torch.Generator(device="cpu").manual_seed(0)
    fp64 = get_scheme("fp64")
    poisson = bag[:4]
    cases = []   # (label, kernel, csrs, layout, backend)
    for csrs, tag in ((bag, "main"), (int16_bag(), "int16"),
                      (wide_bag(), "wide"), (hub_bag(), "hubs")):
        cases.append((f"sell/{tag}", "spmv_sell", csrs, "sell", "xla"))
    cases.append(("rowell/poisson", "spmv_sell", poisson, "rowell", "xla"))
    cases.append(("rowell/int16", "spmv_sell", int16_bag(), "rowell", "xla"))
    cases.append(("ellpack/poisson", "spmv_ellpack", poisson, "ellpack",
                  "pallas"))
    cases.append(("ellpack/int16bag", "spmv_ellpack", int16_bag(), "ellpack",
                  "pallas"))
    for w in ELL_WIDTHS:
        cases.append((f"ellpack/E{w}", "spmv_ellpack", width_bag(w),
                      "ellpack", "pallas"))
    timed = {}
    for label, kname, csrs, layout, backend in cases:
        # the width cases keep their exact E (bucketing rounds it up to a
        # power of two)
        exact = label.startswith("ellpack/E")
        t0 = time.perf_counter()
        mat, stacked, groups, n_ct, _ = stack_operands(
            csrs, backend=backend, layout=layout, scheme=fp64, device=dev,
            bucket=not exact)
        pack_s = time.perf_counter() - t0
        n_pad = stacked.padded_rows
        G = len(csrs)
        if exact and mat[1].shape[3] != int(label[9:]):
            raise AssertionError(f"{label}: stacked slab width "
                                 f"{mat[1].shape[3]}")
        x = torch.randn((G, n_pad), generator=gen,
                        dtype=torch.float64).to(dev)
        table = mat[3] if layout == "sell" else None
        note = ""
        if table is not None:
            note = (f", slots streamed {table.streamed_slots(G)} of "
                    f"{mat[0].numel()} stored, grid {table.grid_x} × {G}"
                    f"{', generic tree' if table.wide else ''}")
        A64 = None              # the library's CSR, built once a case
        for name in SCHEMES + TIER:
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
                same = _same
            else:
                cols, v64 = mat[0], mat[1]
                Gd = cols.shape[0]
                cols = cols.reshape(Gd, -1)
                v = v64.reshape(Gd, -1).to(sch.matrix_dtype)
                grp = groups if layout == "sell" else ((n_pad,
                                                        mat[0].shape[1]),)
                args = (cols, v, x)
                kern, plain = K.spmv_sell, K.spmv_sell_plain
                kw = dict(groups=grp, scheme=sch, table=table)
                in_b = x.numel() * in_el
                stream = (cols, v)
                same = _bits
            y_k = kern(*args, **kw)
            y_p = plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            if not same(y_k, y_p):
                raise AssertionError(
                    f"{label}/{name}: kernel differs from its plain version "
                    f"(max |Δ| {err})")
            idx = "int16" if stream[0].dtype == torch.int16 else "int32"
            how = "bit for bit" if same is _bits else "bitwise"
            log(f"  {label:18s} {name:8s} {idx}: {how} equal (G={G}, "
                f"n_pad={n_pad}, stream {nbytes(*stream)} B, pack "
                f"{pack_s:.2f} s{note})")
            main = label in ("sell/main", "ellpack/poisson") and (
                name in ("mixed_v3", "fp64") or name in TIER)
            if not main or (name == "fp64" and layout != "sell"):
                continue
            # bound_ms counts what this bag needs: its nonzeros' values and
            # indices at their at-rest widths, x read and y written once
            # per row.  bound_stored_ms counts every stored slot of the
            # padded layout, x and y as allocated; SELL's
            # bound_streamed_ms the slots below each lane's own width (what
            # the kernel reads).
            nnz = sum(a.nnz for a in csrs)
            rows = sum(a.shape[0] for a in csrs)
            idx_t = stream[-1] if layout == "ellpack" else stream[0]
            slot_b = v.element_size() + idx_t.element_size()
            need = nnz * slot_b + rows * (in_el + y_k.element_size())
            b_ms, b_by = bound_ms(need, 2 * nnz, sch.spmv_acc_dtype)
            slots = stream[1].numel()
            moved = nbytes(*stream) + in_b + nbytes(y_k)
            st_ms, _ = bound_ms(moved, 2 * slots, sch.spmv_acc_dtype)
            ms = cuda_ms(lambda: kern(*args, **kw))
            if name == "fp64":      # before mixed_v3 in SCHEMES
                fp64_t = dict(ms_fp64=ms, bound_ms_fp64=b_ms)
                log(f"    {kname} fp64: {ms:.3f} ms; bound {b_ms:.4f} ms "
                    f"for {nnz} nonzeros ({need} B, {b_ms / ms:.1%})")
                continue
            plain_ms = cuda_ms(lambda: plain(*args, **kw))
            if A64 is None:
                A64 = block_diag_csr(csrs, n_pad if layout != "ellpack"
                                     else n_ct * stacked.col_tile,
                                     dev, torch.float64)
            xs = (x if layout != "ellpack" else xt).reshape(-1, 1)
            # the faithful rows keep their fp64 yardstick; a tier row's is
            # at its own value dtype
            lib_dt = torch.float64 if name in SCHEMES else sch.matrix_dtype
            lib_ms = library_ms(A64, xs, lib_dt)
            entry = kname if name in SCHEMES else f"{kname}[{name}]"
            timed[entry] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                library_dtype=str(lib_dt).split(".")[-1],
                bound_stored_ms=st_ms, shape=label, nnz=nnz, slots=slots)
            lib = "none" if lib_ms is None else f"{lib_ms:.3f}"
            log(f"    {entry}: {ms:.3f} ms (plain {plain_ms:.3f}, "
                f"{timed[entry]['library_dtype']} torch.sparse.mm {lib}); "
                f"bound {b_ms:.4f} ms by {b_by} for {nnz} nonzeros ({need} "
                f"B, {b_ms / ms:.1%}); stored-slot bound {st_ms:.4f} ms for "
                f"{slots} slots ({moved} B, {moved / ms / 1e6:.1f} GB/s, "
                f"{st_ms / ms:.1%})")
            if table is not None:
                if name == "mixed_v3":
                    timed[entry].update(fp64_t)
                timed[entry].update(_sell_streamed(
                    kern, args, kw, table, stacked, slot_b, in_b,
                    nbytes(y_k), sch, ms, classes=name == "mixed_v3"))
        del A64
    return timed


def _sell_streamed(kern, args, kw, table, stacked, slot_b, in_b, y_b, sch,
                   ms, classes=True) -> dict:
    """The SELL kernel against what it reads: the bound of the slots below
    each lane's own width (x and y as allocated) and, with ``classes``,
    the same kernel on each class of the bag's lanes alone (a table of its
    own)."""
    from repro_torch.kernels import spmv as K
    cols, v, x = args
    G = x.shape[0]
    streamed = table.streamed_slots(G)
    moved = streamed * slot_b + in_b + y_b
    s_ms, _ = bound_ms(moved, 2 * streamed, sch.spmv_acc_dtype)
    blocks = int((table.block_map >= 0).sum())
    log(f"    streamed-slot bound {s_ms:.4f} ms for {streamed} slots "
        f"({moved} B, {moved / ms / 1e6:.1f} GB/s, {s_ms / ms:.1%}); "
        f"{blocks} of {table.grid_x * G} blocks live")
    if not classes:
        return dict(bound_streamed_ms=s_ms, streamed_slots=streamed)
    split = {}
    for name, g0, g1 in BAG_CLASSES:
        tc = K.sell_table(kw["groups"], device=x.device,
                          lane_widths=stacked.lane_widths[g0:g1],
                          slice_rows=stacked.slice_rows)
        sub = (cols[g0:g1], v[g0:g1], x[g0:g1])
        c_ms = median_ms(lambda: kern(*sub, **dict(kw, table=tc)))
        n = tc.streamed_slots(g1 - g0)
        split[name] = c_ms
        log(f"      lanes {g0}-{g1 - 1} ({name}) alone: {c_ms:.4f} ms for "
            f"{n} slots ({n / c_ms / 1e6:.2f} G slots/s, stream "
            f"{n * slot_b / c_ms / 1e6:.1f} GB/s)")
    return dict(bound_streamed_ms=s_ms, streamed_slots=streamed,
                class_ms=split)


# -------------------------------------------------------------- phase 2
def solve_tol(scheme, csrs):
    """The solve's stopping rule: the paper's rr < 1e-12 at the faithful
    schemes; at the tier rr ≤ TIER_RTOL² ‖b‖², b = 1 (per lane)."""
    if scheme in TIER:
        return [TIER_RTOL ** 2 * a.shape[0] for a in csrs]
    return SOLVE_TOL


def _solve(bag, dev, **kw):
    import torch
    from repro_torch.core.batch import jpcg_solve_batched
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = jpcg_solve_batched(bag, tol=solve_tol(kw.get("scheme"), bag),
                             device=dev, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _loop_run(csrs, dev, scheme, backend, layout):
    """The VM solve loop alone on pre-packed operands: the runners that
    ``jpcg_solve_batched(engine="vm")`` builds — specialized, and generic
    (``specialize=False``, the paper program its operand) — and their
    inputs."""
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
    prog = canonical_program("paper")
    kw = dict(backend=backend, scheme=sch, maxiter=20_000, with_trace=False,
              layout=layout, groups=groups, col_tile=512, n_col_tiles=n_ct)
    run = make_vm_runner(program=prog, **kw)
    generic = make_vm_runner(**kw)
    tol = np.broadcast_to(np.asarray(solve_tol(scheme, csrs), np.float64),
                          (len(csrs),))
    args = (mat, _pad_stack([a.diagonal() for a in csrs], n_pad, 1.0, vd,
                            dev),
            _pad_stack([np.ones(a.shape[0]) for a in csrs], n_pad, 0.0, vd,
                       dev),
            torch.zeros((len(csrs), n_pad), dtype=vd, device=dev),
            torch.tensor(tol, dtype=vd, device=dev))
    return run, (lambda *a: generic(prog, *a)), args


def _timed(run, args):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(*args)
    torch.cuda.synchronize()
    return st, time.perf_counter() - t0


def device_profile(fn):
    """Run ``fn`` once under torch.profiler; ``(result, wall_s, events)``
    with one ``(kernel, device ms, count)`` per CUDA kernel name.  Only the
    device activity is traced: operator events would repeat their kernels'
    time, and sorting tens of thousands of them costs seconds a window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import torch
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [(e.key, e.self_device_time_total / 1e3, e.count)
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    return out, wall, ev


def profile_loop(run, args, loop_s: float, label: str = "") -> dict:
    """Device time by kernel over one whole VM solve (torch.profiler).

    The busy share is against ``loop_s``, the same solve timed without
    the profiler, whose host-side cost slows the launches.
    """
    st, wall, ev = device_profile(lambda: run(*args))
    ticks = int(st.k)
    busy_ms = sum(t for _, t, _ in ev)
    n_kernels = sum(c for _, _, c in ev)
    log(f"    profile{label}: {ticks} ticks, {n_kernels} kernels "
        f"({n_kernels / ticks:.1f}/tick), device busy {busy_ms:.1f} ms = "
        f"{busy_ms / ticks:.3f} ms/tick = {busy_ms / 1e3 / loop_s:.1%} of "
        f"the unprofiled loop ({loop_s:.3f} s = {loop_s / ticks * 1e3:.3f} "
        f"ms/tick; {wall:.3f} s profiled)")
    for key, t, c in sorted(ev, key=lambda e: -e[1])[:8]:
        log(f"      {t:9.1f} ms {c:7d}x  {key[:90]}")
    return dict(busy_ms=busy_ms, ticks=ticks, kernels=n_kernels,
                ms_per_tick=loop_s / ticks * 1e3,
                busy_share=busy_ms / 1e3 / loop_s)


def phase_solve(bag, dev):
    """VM ≡ phases on the card, every lane converged (the faithful schemes
    to a true residual ≤ RESIDUAL_MAX; the tier's true residuals logged);
    the generic VM ≡ the specialized one on the mixed_v3 SELL bag; the
    loop timed alone on pre-packed operands, and profiled."""
    import numpy as np
    import torch
    from repro_torch.sparse.stacking import choose_layout

    rows = []
    # (scheme, backend, lanes, full): a full run holds VM ≡ phases and
    # times the loop alone; the tier sweep runs every tier instantiation
    # of row-ELL and ELLPACK through the VM once on the Poisson lanes
    runs = [("mixed_v3", "xla", bag, True), ("fp64", "xla", bag, True),
            ("mixed_v3", "pallas", bag[:4], True),
            ("mixed_v3", "xla", bag[:4], True),
            ("tpu_v3", "xla", bag, True), ("tpu_v3", "xla", bag[:4], True)]
    runs += [(s, backend, bag[:4], False) for s in TIER
             for backend in ("xla", "pallas")
             if (s, backend) != ("tpu_v3", "xla")]
    profiles = {}
    main = None
    for n_run, (scheme, backend, csrs, full) in enumerate(runs):
        layout = choose_layout(
            csrs, default="rowell" if backend == "xla" else "ellpack")
        out = {}
        engines = {"vm": {}}
        if full:
            engines["phases"] = {"engine": "phases"}
        if n_run == 0:                  # the generic VM on the main bag
            engines["generic"] = {"specialize": False}
        for engine, ekw in engines.items():
            out[engine] = _solve(csrs, dev, scheme=scheme, backend=backend,
                                 **ekw)
        vm, t_vm = out["vm"]
        if n_run == 0:
            main = vm
        for other in [e for e in engines if e != "vm"]:
            same = _bits if other == "generic" else _same
            for g, (r_v, r_o) in enumerate(zip(vm, out[other][0])):
                if not (r_v.iterations == r_o.iterations
                        and r_v.status == r_o.status
                        and same(r_v.x, r_o.x)):
                    raise AssertionError(
                        f"{scheme}/{layout} lane {g}: VM differs from "
                        f"{other} ({r_v.iterations} vs {r_o.iterations})")
        for g, (a, r_v) in enumerate(zip(csrs, vm)):
            res = residual(a, r_v.x)
            if scheme in TIER:
                log(f"    {scheme}/{layout} lane {g}: {r_v.status} after "
                    f"{r_v.iterations}, ‖r‖²/‖b‖² {r_v.rr / a.shape[0]:.3e}, "
                    f"true residual {res:.3e}")
                if r_v.status != "CONVERGED" or not np.isfinite(res):
                    raise AssertionError(
                        f"{scheme}/{layout} lane {g}: {r_v.status}, true "
                        f"residual {res:.3e}")
            elif r_v.status != "CONVERGED" or res > RESIDUAL_MAX:
                raise AssertionError(
                    f"{scheme}/{layout} lane {g}: {r_v.status}, true "
                    f"residual {res:.3e}")
        if not full:
            log(f"  {scheme}/{layout} G={len(csrs)}: iterations "
                f"{[r.iterations for r in vm]}, jpcg_solve_batched "
                f"{t_vm:.3f} s")
            continue
        t_ph = out["phases"][1]
        t0 = time.perf_counter()
        run, run_g, args = _loop_run(csrs, dev, scheme, backend, layout)
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
        held = " ≡ ".join(["VM"] + [e for e in engines if e != "vm"])
        log(f"  {scheme}/{layout} G={len(csrs)}: iterations {its}; "
            f"jpcg_solve_batched vm {t_vm:.3f} s, phases {t_ph:.3f} s "
            f"({row['systems_per_s']:.3f} systems/s, "
            f"{row['iterations_per_s']:.1f} iterations/s); packing "
            f"{pack_s:.3f} s; loop alone {loop_s:.3f} s over {ticks} ticks "
            f"= {row['ms_per_tick']:.3f} ms/tick "
            f"({row['loop_systems_per_s']:.2f} systems/s); max residual "
            f"{row['max_residual']:.2e}; {held} bit for bit")
        if n_run in (0, 2, 4):
            profiles[(scheme, layout)] = profile_loop(
                run, args, loop_s, label=" (specialized)" if n_run == 0
                else "")
        if n_run == 0:
            # the generic tick beside the specialized one: a record, not a
            # gate (it commits the whole mem and queue files every tick)
            t_g = out["generic"][1]
            st_g, loop_g = _timed(run_g, args)
            if st_g.it.cpu().tolist() != its or not _bits(st_g.mem,
                                                          st.mem):
                raise AssertionError("generic loop-only run differs from "
                                     "the specialized one")
            log(f"  generic VM {scheme}/{layout}: jpcg_solve_batched "
                f"(specialize=False) {t_g:.3f} s; loop alone {loop_g:.3f} "
                f"s = {loop_g / ticks * 1e3:.3f} ms/tick (specialized "
                f"{row['ms_per_tick']:.3f}); state ≡ the specialized "
                f"loop's bit for bit")
            profiles[("generic", layout)] = profile_loop(
                run_g, args, loop_g, label=" (generic)")
            row["generic_s"] = t_g
            del st_g
    return rows, profiles, main


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


def phase_engine_generic(bag, dev):
    """One ``SolverEngine(specialize=False)`` serves the same two lanes
    (``poisson_2d(500)``, a power-law lane; SELL, mixed_v3) under the
    paper and the min-traffic policy through one cached generic stepper;
    the two policies' results are equal bit for bit."""
    from repro_torch.core.vm import vm_executable_stats
    from repro_torch.serve import SolverEngine, SolverEngineConfig
    eng = SolverEngine(SolverEngineConfig(
        batch_slots=2, chunk_iters=64, backend="xla", layout="sell",
        specialize=False, device=str(dev)))
    lanes = (bag[0], bag[6])
    before = vm_executable_stats()
    t0 = time.perf_counter()
    rids = {(policy, k): eng.submit(a, policy=policy)
            for policy in ("paper", "min_traffic")
            for k, a in enumerate(lanes)}
    admit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    done = eng.run_to_completion()
    run_s = time.perf_counter() - t0
    after = vm_executable_stats()
    new = {k: after[k] - before[k] for k in after}
    if new != {"executables": 1, "specialized": 0, "generic": 1}:
        raise AssertionError(f"generic engine: new steppers {new}, "
                             "expected one generic stepper for both pools")
    its = []
    for k, a in enumerate(lanes):
        p, m = done[rids[("paper", k)]], done[rids[("min_traffic", k)]]
        res = residual(a, p.x)
        if not (p.iterations == m.iterations and p.status == m.status
                and _bits(p.x, m.x)):
            raise AssertionError(f"generic engine lane {k}: paper "
                                 f"{p.iterations} vs min_traffic "
                                 f"{m.iterations} iterations")
        if p.status != "CONVERGED" or res > RESIDUAL_MAX:
            raise AssertionError(f"generic engine lane {k}: {p.status}, "
                                 f"true residual {res:.3e}")
        its.append(p.iterations)
    log(f"  generic engine: 2 pools (paper, min_traffic) × {len(lanes)} "
        f"lanes through one cached generic stepper ({new}); admit "
        f"{admit_s:.2f} s, run {run_s:.2f} s, iterations {its}; the two "
        f"policies' results equal bit for bit")
    return dict(admit_s=admit_s, run_s=run_s, iterations=its)


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
DOT_N = (1, 2047, 2048, 2049, 10**6)    # around one chunk of 2,048


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


#: dot3 beyond phase 5's common sizes: ten million leaves (4,883 chunks,
#: 32 chunk sums a thread in the finish) and, at fp32, more than 2^24
#: (8,193 chunks, 64 a thread)
DOT3_LONG = (("float64", 10**7), ("float32", 2**24 + 2049))


def dot3_checks(dev, gen, errs) -> dict:
    """The bulk-copy kernel ``dot3`` against ``dot3_plain``, bit for
    bit: every n of ``DOT_N`` and the long ones, three calls in a row of
    different n, a call on a second stream while the first stream's is in
    flight (a ticket each), r, u and w one to three elements into their
    storage (the plain-load path), and one kernel a call in the profiler.
    Times it cold at n = 10^6 (fp64, fp32) and 10^7 (fp64) beside its
    bound, and logs the sum of three ``torch.dot`` calls at the same sizes
    for the reader (no one PyTorch call computes [r·u, w·u, r·r]), beside
    the timer's floor and dot3 at one chunk."""
    import torch
    from repro_torch.kernels import dot as D

    def hold(label, got, want):
        _held(f"dot3/{label}", got, want, errs, "dot3")
        if not _bits(got, want):
            raise AssertionError(f"dot3/{label}: not bit for bit: "
                                 f"{got.tolist()} vs {want.tolist()}")

    def vecs(nn, dt, offsets=(0, 0, 0)):
        return [torch.randn(nn + o, generator=gen, dtype=dt).to(dev)[o:]
                for o in offsets]

    for dt in (torch.float64, torch.float32):
        name = str(dt)[6:]
        sizes = DOT_N + tuple(nn for d, nn in DOT3_LONG if d == name)
        for nn in sizes:
            hold(f"{name}/n={nn}", D.dot3(*(v := vecs(nn, dt))),
                 D.dot3_plain(*v))
        # three calls in a row, no synchronisation: the ticket resets
        trio = [vecs(nn, dt) for nn in (10**7 + 1, 2049, 3 * 10**5 + 7)]
        got = [D.dot3(*v) for v in trio]
        for v, g in zip(trio, got):
            hold(f"{name}/in a row", g, D.dot3_plain(*v))
        # one call in flight on each of two streams
        big, small = vecs(10**7, dt), vecs(10**6 + 3, dt)
        side = torch.cuda.Stream(device=dev)
        torch.cuda.synchronize()
        g_big = D.dot3(*big)
        with torch.cuda.stream(side):
            g_small = D.dot3(*small)
        torch.cuda.synchronize()
        hold(f"{name}/two streams", g_big, D.dot3_plain(*big))
        hold(f"{name}/two streams", g_small, D.dot3_plain(*small))
        # storage offsets: no slice of r or w is 16-byte aligned
        offsets = (1, 0, 1) if dt == torch.float64 else (1, 2, 3)
        for nn in (10**6, 10**6 + 3):
            hold(f"{name}/offsets {offsets}/n={nn}",
                 D.dot3(*(v := vecs(nn, dt, offsets))), D.dot3_plain(*v))
        log(f"  dot3 {name}: n={sizes}, three in a row, two streams, "
            f"storage offsets {offsets}: bitwise equal")
    # one kernel a call: 3 calls between two runs of 2,000 elementwise
    # kernels.  Late in the smoke the profiler loses the first and last few
    # kernels of a window (the first 3 of a window of 3 calls and 2,000 pads
    # after them); a long window never shows it.  All but the padding must
    # be dot3_bulk.
    v = vecs(10**6, torch.float64)
    pad = torch.zeros(1, device=dev)

    def window():
        for _ in range(2000):
            pad.add_(1.0)
        out = [D.dot3(*v) for _ in range(3)]
        for _ in range(2000):
            pad.add_(1.0)
        return out

    _, _, ev = device_profile(window)
    bulk = sum(c for k, _, c in ev if "dot3_bulk" in k)
    other = {k[:60]: c for k, _, c in ev if "dot3_bulk" not in k}
    if bulk != 3 or any("elementwise" not in k for k in other):
        raise AssertionError(f"dot3: 3 calls ran the kernels {ev}")
    log(f"  dot3 profile of 3 calls: {bulk} dot3_bulk kernels (and "
        f"{sum(other.values())} of the 4,000 padding)")
    # what the timer reads for a launch that moves no data, and dot3's own
    # fixed cost (one block, one chunk: copy latency, tree, ticket, finish)
    one = vecs(2048, torch.float64)
    sizes = {"timer_floor_ms": cold_ms(lambda: pad.add_(1.0)),
             "one_chunk_ms": cold_ms(lambda: D.dot3(*one))}
    log(f"    cold_ms of one 1-element kernel {sizes['timer_floor_ms']:.4f} "
        f"ms; dot3 at n = 2048 (one chunk) {sizes['one_chunk_ms']:.4f} ms")
    for dt, nn in ((torch.float64, 10**6), (torch.float32, 10**6),
                   (torch.float64, 10**7)):
        r, u, w = vecs(nn, dt)
        el = r.element_size()
        b_ms, b_by = bound_ms(3 * nn * el, 6 * nn, dt)
        ms = cold_ms(lambda: D.dot3(r, u, w))
        three = cold_ms(lambda: (torch.dot(r, u), torch.dot(w, u),
                                 torch.dot(r, r)))
        key = f"{str(dt)[6:]}/n={nn}"
        sizes[key] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                          share=b_ms / ms, three_torch_dot_ms=three)
        log(f"    dot3 {key}: {ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
            f"({b_ms / ms:.1%}); three torch.dot {three:.4f} ms "
            f"({b_ms / three:.1%}; for the reader)")
    return sizes


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
    A64 = block_diag_csr([a], n, dev, torch.float64)
    xs = xt.reshape(-1)[:n].reshape(-1, 1).contiguous()
    for name in SCHEMES + TIER:
        sch = get_scheme(name)
        v = torch.from_numpy(m.vals).to(dev, sch.matrix_dtype)
        args = (tc, v, lc, xt)
        y_k = K.spmv_ell(*args, scheme=sch)
        entry = "spmv_ell" if name in SCHEMES else f"spmv_ell[{name}]"
        _held(f"spmv_ell/{name}", y_k, K.spmv_ell_plain(*args, scheme=sch),
              errs, entry)
        log(f"  spmv_ell {name:8s}: bitwise equal")
        if name != "mixed_v3" and name not in TIER:
            continue
        in_el = torch.empty((), dtype=sch.spmv_in_dtype).element_size()
        acc_el = y_k.element_size()
        need = a.nnz * (v.element_size() + lc.element_size()) \
            + n * (in_el + acc_el)
        b_ms, b_by = bound_ms(need, 2 * a.nnz, sch.spmv_acc_dtype)
        moved = nbytes(tc, v, lc) + xt.numel() * in_el + nbytes(y_k)
        st_ms, _ = bound_ms(moved, 2 * v.numel(), sch.spmv_acc_dtype)
        lib_dt = torch.float64 if name in SCHEMES else sch.matrix_dtype
        timed[entry] = dict(
            ms=cold_ms(lambda: K.spmv_ell(*args, scheme=sch)),
            plain_ms=cold_ms(lambda: K.spmv_ell_plain(*args, scheme=sch)),
            library_ms=library_ms(A64, xs, lib_dt, timer=cold_ms),
            bound_ms=b_ms, bound_by=b_by, bound_stored_ms=st_ms,
            library_dtype=str(lib_dt).split(".")[-1], bytes=need,
            stored_bytes=moved)
    del A64
    for w in ELL_WIDTHS:
        mw = csr_to_ellpack(banded(5000, w, 100 + w))
        if mw.ell != w:
            raise AssertionError(f"banded width {w}: slab width {mw.ell}")
        targs = [torch.from_numpy(t).to(dev)
                 for t in (mw.tile_cols, mw.local_cols)]
        xw = torch.randn(mw.padded_cols, generator=gen, dtype=torch.float64
                         ).reshape(-1, mw.col_tile).to(dev)
        for name in SCHEMES + TIER:
            sch = get_scheme(name)
            v = torch.from_numpy(mw.vals).to(dev, sch.matrix_dtype)
            args = (targs[0], v, targs[1], xw)
            entry = "spmv_ell" if name in SCHEMES else f"spmv_ell[{name}]"
            _held(f"spmv_ell/E{w}/{name}", K.spmv_ell(*args, scheme=sch),
                  K.spmv_ell_plain(*args, scheme=sch), errs, entry)
        log(f"  spmv_ell E={w}: bitwise equal for {len(SCHEMES + TIER)} "
            "schemes")

    # dot is one launch whose last block finishes the sum: every chunk
    # count around a whole chunk, then three calls in a row of different
    # lengths with no synchronisation between (the ticket resets)
    for dt in (torch.float64, torch.float32):
        for nn in DOT_N:
            p, ap = (torch.randn(nn, generator=gen, dtype=dt).to(dev)
                     for _ in range(2))
            _held(f"dot/{str(dt)[6:]}/n={nn}", D.dot(p, ap),
                  D.dot_plain(p, ap), errs, "dot")
        pairs = [tuple(torch.randn(nn, generator=gen, dtype=dt).to(dev)
                       for _ in range(2)) for nn in (5000, 2049, 3 * 10**5)]
        got = [D.dot(p, ap) for p, ap in pairs]
        for (p, ap), g in zip(pairs, got):
            _held(f"dot/{str(dt)[6:]}/in a row", g, D.dot_plain(p, ap),
                  errs, "dot")
        log(f"  dot {str(dt)[6:]} n={DOT_N} and three calls in a row: "
            "bitwise equal")
    dot3_sizes = dot3_checks(dev, gen, errs)
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
    timed["dot3"]["sizes"] = dot3_sizes
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


# ------------------------------------------------------------- phase 5b
def _pack_cases():
    """Small matrices for the packer: ragged blocks, unsorted columns with
    duplicates, emptied rows, no nonzeros."""
    import numpy as np
    from repro_torch.sparse import CSRMatrix, csr_from_coo, poisson_2d
    rng = np.random.default_rng(5)
    indptr, cols = [0], []
    for i in range(600):
        k = int(rng.integers(0, 10))
        row = list(rng.integers(0, 600, size=k))
        cols += row + ([row[0], i, i] if k else [])
        indptr.append(len(cols))
    scrambled = CSRMatrix(np.array(indptr, np.int64), np.array(cols, np.int32),
                          rng.standard_normal(len(cols)), (600, 600))
    p = poisson_2d(30)
    keep = np.repeat(np.arange(p.n_rows) % 3 != 1, p.row_nnz())
    rows = np.repeat(np.arange(p.n_rows), p.row_nnz())[keep]
    emptied = csr_from_coo(rows, p.indices[keep], p.data[keep], p.shape)
    empty = CSRMatrix(np.zeros(301, np.int64), np.zeros(0, np.int32),
                      np.zeros(0), (300, 300))
    return {"poisson": poisson_2d(37), "scrambled": scrambled,
            "emptied": emptied, "zero_nnz": empty}


def _pack_both(a, dev, scheme, dims_of, **kw):
    """The packer on the card and its plain version on the CPU, the card's
    into a lane filled with stale values; ``(card, plain, geometry,
    dims)``."""
    import torch
    from repro_torch.kernels import pack
    plain_csr = pack.CSRTensors.from_csr(a, "cpu")
    geometry = pack.ellpack_geometry_plain(plain_csr, **kw)
    dims = dims_of(geometry)
    want = pack.ellpack_pack_plain(
        plain_csr, geometry, dims, matrix_dtype=scheme.matrix_dtype,
        vector_dtype=scheme.vector_dtype, **kw)
    csr = pack.CSRTensors.from_csr(a, dev)
    got_geometry = pack.ellpack_geometry(csr, **kw)
    if got_geometry != geometry:
        raise AssertionError(f"ellpack_geometry {got_geometry} on the card, "
                             f"{geometry} in the plain version")
    out = tuple(torch.full_like(t, 7, device=dev) for t in want)
    got = pack.ellpack_pack(csr, geometry, dims,
                            matrix_dtype=scheme.matrix_dtype,
                            vector_dtype=scheme.vector_dtype, out=out, **kw)
    return got, tuple(t.to(dev) for t in want), geometry, dims


def phase_pack(single, dev):
    """``ellpack_geometry`` and ``ellpack_pack`` against their plain
    versions, bit for bit, and timed at ecology2's shape."""
    import torch
    from repro_torch.core.precision import get_scheme
    from repro_torch.kernels import pack
    from repro_torch.sparse import bucket_up
    errs = {}
    for name, a in _pack_cases().items():
        for (R, C), scheme, bucketed in itertools.product(
                ((32, 64), (256, 512)), SCHEMES + TIER, (False, True)):
            grow = ((lambda g: tuple(bucket_up(d + 1) for d in g[:3]))
                    if bucketed else (lambda g: g[:3]))
            got, want, _, dims = _pack_both(a, dev, get_scheme(scheme), grow,
                                            block_rows=R, col_tile=C)
            for g, w in zip(got, want):
                _held(f"{name}/{R}x{C}/{scheme}/{dims}", g, w, errs,
                      "ellpack_pack")
    log(f"  ellpack_pack: {len(_pack_cases())} matrices × 2 blockings × "
        f"{len(SCHEMES + TIER)} schemes × 2 dims, bitwise equal")

    sch = get_scheme("mixed_v3")
    kw = dict(block_rows=256, col_tile=512)
    n, nnz = single.shape[0], single.nnz
    timed = {}
    for label, dims_of in (("bucket", lambda g: tuple(bucket_up(d)
                                                      for d in g[:3])),
                           ("own", lambda g: g[:3])):
        t0 = time.perf_counter()
        got, want, geometry, dims = _pack_both(single, dev, sch, dims_of,
                                               **kw)
        for g, w in zip(got, want):
            _held(f"poisson_2d(1000)/{label}", g, w, errs, "ellpack_pack")
        log(f"  poisson_2d(1000) at {label} dims {dims} (geometry "
            f"{geometry}): bitwise equal ({time.perf_counter() - t0:.1f} s "
            "with the plain version on the CPU)")
        csr = pack.CSRTensors.from_csr(single, dev)
        lane = tuple(torch.empty_like(t) for t in got)
        run = lambda: (pack.ellpack_geometry(csr, **kw),   # noqa: E731
                       pack.ellpack_pack(csr, geometry, dims, out=lane,
                                         matrix_dtype=sch.matrix_dtype,
                                         vector_dtype=sch.vector_dtype,
                                         **kw))
        run()
        for g, w in zip(lane, got):
            if not _same(g, w):
                raise AssertionError("ellpack_pack: a repeated pack differs")
        flush = torch.zeros(256 << 20, dtype=torch.float32, device=dev)
        reps = 20

        def cold_runs():
            for _ in range(reps):
                flush.sum()
                run()
        _, _, ev = device_profile(cold_runs)
        passes = {k: (t, c) for k, t, c in ev if "ellpack_" in k}
        ms = sum(t for t, _ in passes.values()) / reps
        csr_bytes = csr.nbytes
        lane_bytes = nbytes(*got)
        b_ms, b_by = bound_ms(csr_bytes + lane_bytes, 0, torch.float64)
        plain = pack.CSRTensors.from_csr(single, dev)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = pack.ellpack_geometry_plain(plain, **kw)
            pack.ellpack_pack_plain(plain, g, dims,
                                    matrix_dtype=sch.matrix_dtype,
                                    vector_dtype=sch.vector_dtype, **kw)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        plain_ms = sorted(walls)[1]
        timed[label] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
            bound_by=b_by, bytes=csr_bytes + lane_bytes,
            csr_bytes=csr_bytes, lane_bytes=lane_bytes, dims=list(dims),
            passes={k: t / reps for k, (t, c) in passes.items()},
            shape=f"poisson_2d(1000): n {n}, nnz {nnz}")
        log(f"    ellpack_pack [{label} {dims}]: {ms:.4f} ms a pack "
            f"({', '.join(f'{k[:40]} {t / reps:.4f}' for k, (t, c) in passes.items())}; "
            f"plain on the card {plain_ms:.1f} ms wall); bound "
            f"{b_ms:.4f} ms by {b_by} (CSR {csr_bytes} B + lane "
            f"{lane_bytes} B, {b_ms / ms:.1%})")
    t = dict(timed["bucket"], own=timed["own"], max_abs_err=errs[
        "ellpack_pack"])
    return {"ellpack_pack": t}


# -------------------------------------------------------------- phase 6
SINGLE_RUNS = (("vsr", "pallas", "mixed_v3"), ("vsr", "pallas", "fp64"),
               ("vsr", "xla", "mixed_v3"), ("pipelined", "xla", "mixed_v3"),
               ("vsr", "pallas", "tpu_v3"))


def _single(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_single_solve(a, dev):
    """``jpcg_solve`` at full size on every requested method, backend and
    scheme; returns the launches of the calls from the CSR, and each run's
    result and loop time by ``(method, backend, scheme)``."""
    import numpy as np
    import torch
    from repro_torch import jpcg_solve
    from repro_torch.core.operators import as_operator
    from repro_torch.kernels import ops

    launches = {}
    out, loops = {}, {}
    for method, backend, scheme in SINGLE_RUNS:
        tol = solve_tol(scheme, [a])
        kw = dict(method=method, backend=backend, scheme=scheme,
                  tol=tol if scheme not in TIER else tol[0], maxiter=20_000,
                  device=dev)
        ops.reset_launches()
        res, call_s = _single(lambda: jpcg_solve(a, **kw))
        counts = ops.launches()
        its = res.iterations
        res_true = residual(a, res.x)
        if not res.converged or not (res_true <= RESIDUAL_MAX or (
                scheme in TIER and np.isfinite(res_true))):
            raise AssertionError(f"{method}/{backend}/{scheme}: converged "
                                 f"{res.converged} after {its}, true "
                                 f"residual {res_true:.3e}")
        if backend == "pallas":
            # the operator packed on the card (both passes once); one SpMV
            # per iteration plus init_state's, one dot, phase 2 and phase 3
            # per iteration: no plain version on this path
            want = dict.fromkeys(counts, 0)
            want.update(spmv_ell=its + 1, dot=its, phase2=its, phase3=its,
                        ellpack_geometry=1, ellpack_scatter=1)
            if scheme in TIER:
                want[f"spmv_ell[{scheme}]"] = its + 1
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
        loops[(method, backend, scheme)] = loop_s
        log(f"  {method}/{backend}/{scheme}: {its} iterations (rr "
            f"{res.rr:.3e}, tol {kw['tol']:.3e}), call {call_s:.3f} s "
            f"({call_s / its * 1e3:.3f} ms/iteration); operator build "
            f"{pack_s:.3f} s; loop alone {loop_s:.3f} s = "
            f"{loop_s / its * 1e3:.4f} ms/iteration, the same iterations "
            f"and x bit for bit; true residual {res_true:.2e}")
        if (method, backend, scheme) in (SINGLE_RUNS[0], SINGLE_RUNS[-1]):
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
    return launches, out, loops


# ------------------------------------------------------------- phase 6b
def _shard_states(st):
    """A runner's result as a list of lane shards' states."""
    from repro_torch.core.shard import Shards
    return list(st) if isinstance(st, Shards) else [st]


#: ticks (iterations) of the profiled window in phases 6b and 6c: the
#: profiler's post-processing grows with the events it holds, and a tick's
#: kernels do not depend on how many lanes are still live
PROFILE_TICKS = 100


def _loop_profile(window, args, loop_s: float, ticks: int,
                  label: str) -> dict:
    """The loop timed at ``loop_s`` over ``ticks`` ticks, and ``window``
    (the same runner stopped after PROFILE_TICKS ticks) profiled: ms per
    tick, kernels and device ms per tick, and the device-busy share of
    the unprofiled tick."""
    _, wall, ev = device_profile(lambda: window(*args))
    busy_ms = sum(t for _, t, _ in ev)
    n_k = sum(c for _, _, c in ev)
    ms = loop_s / ticks * 1e3
    row = dict(ticks=ticks, loop_s=loop_s, ms_per_tick=ms,
               kernels_per_tick=n_k / PROFILE_TICKS,
               busy_ms_per_tick=busy_ms / PROFILE_TICKS,
               busy_share=busy_ms / PROFILE_TICKS / ms)
    log(f"    {label} loop alone: {loop_s:.3f} s over {ticks} ticks = "
        f"{ms:.3f} ms/tick; profiled over its first {PROFILE_TICKS} "
        f"ticks: {row['kernels_per_tick']:.1f} kernels/tick, device busy "
        f"{row['busy_ms_per_tick']:.3f} ms/tick = {row['busy_share']:.1%} "
        f"({wall:.3f} s profiled)")
    return row


#: (n, dtype) of the row-dot check: the bag's n_pad, and lanes of 4 M and
#: ~8.4 M rows (long rows are where CUDA's plain sum splits a row over
#: blocks by the number of rows), at the faithful schemes' fp64 vectors
#: and the tier's fp32
ROW_DOT_CASES = ((262144, "float64"), (4194304, "float64"),
                 (8388611, "float64"), (262144, "float32"),
                 (8388611, "float32"))


def _row_dot_lane_invariance(dev):
    """A record beside the sharded solve: CUDA's plain ``sum`` over the
    last dim of [G, n] gives a row other bits at G = 4 than at G = 8, which
    is why the batched row dot is staged (``core.batch._row_dot``).  The
    staged dot must give every row the same bits at G = 8 as cut into
    G = 4, 2 and 1, at each of ``ROW_DOT_CASES``."""
    import torch
    from repro_torch.core.batch import _row_dot
    gen = torch.Generator(device=dev).manual_seed(17)

    def rows_moved(f, a, b, g):
        whole = f(a, b)
        cut = torch.cat([f(a[i:i + g], b[i:i + g]) for i in range(0, 8, g)])
        return int((whole != cut).sum())

    def bits(f):
        return lambda u, v: f(u, v).view(
            torch.int64 if u.dtype == torch.float64 else torch.int32)

    plain, staged = None, {}
    for n, dtype in ROW_DOT_CASES:
        dt = getattr(torch, dtype)
        a = torch.randn((8, n), dtype=dt, device=dev, generator=gen)
        b = torch.randn((8, n), dtype=dt, device=dev, generator=gen)
        if plain is None:
            plain = rows_moved(bits(lambda u, v: (u * v).sum(-1)), a, b, 4)
        staged[(n, dtype)] = [rows_moved(bits(_row_dot), a, b, g)
                              for g in (4, 2, 1)]
        del a, b
    log(f"  row dot, 8 rows at G 8 against G 4, 2, 1: plain sum(-1) at n "
        f"262,144 fp64 changes {plain} of 8 rows' bits at G 4; the staged "
        "_row_dot changes "
        + ", ".join(f"{m} at n {n:,} {d}" for (n, d), m in staged.items()))
    if any(any(m) for m in staged.values()):
        raise AssertionError("the batched row dot depends on the lane count")
    return plain


def phase_sharded(bag, dev, main, unsharded_ms):
    """Lane sharding on the card: ``jpcg_solve_batched(mesh=)`` on the
    mixed_v3 SELL bag over ``lane_mesh()`` (D = 1 here) and over
    ``(cuda:0, cuda:0)`` (D = 2), each bit for bit phase 2's unsharded
    solve (x, rr, iterations, statuses); each loop timed and profiled on
    operands packed once on the host; then a D = 2 ``SolverEngine`` on the
    Poisson lanes through ELLPACK against the unsharded engine."""
    import numpy as np
    import torch
    from repro_torch.core.batch import (_pad_stack, jpcg_solve_batched,
                                        stack_operands)
    from repro_torch.core.compile import canonical_program
    from repro_torch.core.precision import get_scheme
    from repro_torch.core.shard import lane_mesh, place_lanes
    from repro_torch.core.vm import make_vm_runner
    from repro_torch.serve import SolverEngine, SolverEngineConfig

    plain_rows = _row_dot_lane_invariance(dev)
    meshes = {"D=1": lane_mesh(), "D=2": (dev, dev)}
    tol = solve_tol("mixed_v3", bag)
    out = {"row_dot_plain_rows_moved": plain_rows}
    for label, mesh in meshes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = jpcg_solve_batched(bag, tol=tol, scheme="mixed_v3",
                                 backend="xla", mesh=mesh)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        for g, (r, m) in enumerate(zip(res, main)):
            if not (r.iterations == m.iterations and r.status == m.status
                    and np.float64(r.rr).tobytes() ==
                    np.float64(m.rr).tobytes()
                    and _bits(r.x.to(dev), m.x)):
                raise AssertionError(
                    f"sharded {label} lane {g}: {r.iterations} "
                    f"iterations, {r.status}, against unsharded "
                    f"{m.iterations}, {m.status}")
        out[label] = dict(call_s=call_s, devices=[str(d) for d in mesh])
        log(f"  mixed_v3/sell {label} on {[str(d) for d in mesh]}: "
            f"jpcg_solve_batched {call_s:.3f} s; iterations "
            f"{[r.iterations for r in res]}; x, rr, iterations and statuses "
            f"≡ phase 2's unsharded solve bit for bit")
        del res

    # the loop alone: the bag packed once on the host, cut per mesh
    sch = get_scheme("mixed_v3")
    t0 = time.perf_counter()
    mat, stacked, groups, n_ct, _ = stack_operands(
        bag, backend="xla", layout="sell", scheme=sch, device="cpu")
    n_pad, vd, G = stacked.padded_rows, sch.vector_dtype, len(bag)
    args = (mat, _pad_stack([a.diagonal() for a in bag], n_pad, 1.0, vd,
                            "cpu"),
            _pad_stack([np.ones(a.shape[0]) for a in bag], n_pad, 0.0, vd,
                       "cpu"),
            torch.zeros((G, n_pad), dtype=vd),
            torch.full((G,), float(tol), dtype=vd))
    log(f"    packed on the host once in {time.perf_counter() - t0:.3f} s")
    kw = dict(backend="xla", scheme=sch, maxiter=20_000, with_trace=False,
              layout="sell", groups=groups, col_tile=512, n_col_tiles=n_ct)
    prog = canonical_program("paper")
    window = dict(kw, maxiter=PROFILE_TICKS)
    loops = {"unsharded": (None, tuple(place_lanes((dev,), a)[0]
                                       for a in args))}
    for label, mesh in meshes.items():
        loops[label] = (mesh, tuple(place_lanes(mesh, a) for a in args))
    # in turns, each twice; a loop's time is its faster run (the first
    # run of a runner also meets the allocator)
    times = {label: [] for label in loops}
    ticks = {}
    for label in list(loops) + list(loops)[::-1]:
        mesh, placed = loops[label]
        st, t = _timed(make_vm_runner(program=prog, mesh=mesh, **kw), placed)
        times[label].append(t)
        ticks[label] = int(_shard_states(st)[0].k)
        del st
    base = None
    for label, (mesh, placed) in loops.items():
        row = _loop_profile(
            make_vm_runner(program=prog, mesh=mesh, **window), placed,
            min(times[label]), ticks[label], label)
        row["runs_s"] = times[label]
        base = base or row["ms_per_tick"]
        row["vs_unsharded"] = row["ms_per_tick"] / base
        log(f"    {label}: {row['vs_unsharded']:.3f}× the unsharded loop "
            f"on the same operands (phase 2's: {unsharded_ms:.3f} "
            "ms/tick)")
        out.setdefault(label, {}).update(row)
    del loops, mat, args

    # a D = 2 engine on the Poisson lanes through ELLPACK
    def engine(where):
        eng = SolverEngine(SolverEngineConfig(
            batch_slots=4, chunk_iters=64, backend="pallas", **where))
        t0 = time.perf_counter()
        rids = [eng.submit(a) for a in bag[:4]]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.run_to_completion()
        torch.cuda.synchronize()
        return ([eng.results[r] for r in rids], eng.metrics(),
                time.perf_counter() - t1, t1 - t0)

    ref, m_ref, t_ref, a_ref = engine(dict(device=str(dev)))
    got, m_got, t_got, a_got = engine(dict(mesh=(dev, dev)))
    for g, (r, o) in enumerate(zip(got, ref)):
        if not (r.iterations == o.iterations and r.status == o.status
                and _bits(r.x, o.x) and r.status == "CONVERGED"):
            raise AssertionError(f"D=2 engine lane {g}: {r.iterations} "
                                 f"{r.status} against {o.iterations} "
                                 f"{o.status}")
    if (m_got["exit_status"] != m_ref["exit_status"]
            or [p["shards"] for p in m_got["pools"].values()] != [2]):
        raise AssertionError(f"D=2 engine metrics {m_got['exit_status']} "
                             f"against {m_ref['exit_status']}")
    out["engine"] = dict(unsharded_s=t_ref, sharded_s=t_got,
                         unsharded_admit_s=a_ref, sharded_admit_s=a_got,
                         iterations=[r.iterations for r in got])
    log(f"  SolverEngine ELLPACK, 4 Poisson lanes: D=2 on one card run "
        f"{t_got:.3f} s (admit {a_got:.3f} s) against unsharded {t_ref:.3f} "
        f"s (admit {a_ref:.3f} s); iterations "
        f"{[r.iterations for r in got]}, results and exit histogram ≡ the "
        "unsharded engine's bit for bit")
    return out


# ------------------------------------------------------------- phase 6c
def phase_distributed(a, dev, single, single_loops):
    """The row-distributed JPCG on a world-size-1 NCCL group (one shard:
    the whole matrix, no neighbour, so no halo): ``vsr`` and
    ``pipelined`` at mixed_v3, ``comm="allgather"``, against phase 6's
    ``jpcg_solve`` (xla) of the same method; a second solve repeats every
    bit; the all-reduces an iteration are counted."""
    import datetime
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import make_dist_solver
    from repro_torch.distributed.cg_dist import collectives, reset_collectives

    n = a.shape[0]
    b, x0, diag = np.ones(n), np.zeros(n), a.diagonal()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=300))
        try:
            for method, it_tol in (("vsr", 1), ("pipelined", 2)):
                ref = single[(method, "xla", "mixed_v3")]
                solver = make_dist_solver(a, method=method, scheme="mixed_v3",
                                          tol=SOLVE_TOL, maxiter=20_000,
                                          comm="allgather", device=dev)
                part = solver.part
                reset_collectives()
                (x, its, rr), call_s = _single(
                    lambda: solver.solve(b, x0, diag))
                counts = collectives()
                res = residual(a, x)
                x_ref = ref.x
                dx = float((x - x_ref).abs().max())
                scale = float(x_ref.abs().max())
                per_it = (2, 1) if method == "vsr" else (1, 1)
                want_ar = per_it[0] * its + per_it[1]
                if not (rr <= SOLVE_TOL and res <= RESIDUAL_MAX
                        and abs(its - ref.iterations) <= it_tol
                        and counts["all_reduce"] == want_ar):
                    raise AssertionError(
                        f"distributed {method}: {its} iterations (phase 6 "
                        f"{ref.iterations}), rr {rr:.3e}, true residual "
                        f"{res:.3e}, all-reduces {counts['all_reduce']} "
                        f"(want {want_ar})")
                if method == "vsr" and dx > 1e-9 * scale:
                    raise AssertionError(f"distributed vsr: max |Δx| {dx:.3e}"
                                         f" > 1e-9 × max |x| {scale:.3e}")
                if method == "pipelined":
                    np.testing.assert_allclose(
                        x.cpu().numpy(), x_ref.cpu().numpy(), rtol=1e-4,
                        atol=1e-6, err_msg="distributed pipelined")
                (x2, its2, rr2), again_s = _single(
                    lambda: solver.solve(b, x0, diag))
                if not (its2 == its and rr2 == rr and _bits(x2, x)):
                    raise AssertionError(f"distributed {method}: a second "
                                         f"solve took {its2} iterations, "
                                         f"x equal {_bits(x2, x)}")
                window = make_dist_solver(
                    a, method=method, scheme="mixed_v3", tol=SOLVE_TOL,
                    maxiter=PROFILE_TICKS, comm="allgather", part=part,
                    device=dev)
                _, wall, ev = device_profile(lambda: window.solve(b, x0,
                                                                  diag))
                # the window's device time, per iteration, over the solve
                busy_ms = sum(t for _, t, _ in ev) * its / PROFILE_TICKS
                row = dict(iterations=its, ref_iterations=ref.iterations,
                           rr=rr, residual=res, max_dx=dx, max_x=scale,
                           call_s=call_s, again_s=again_s,
                           ms_per_iteration=again_s / its * 1e3,
                           ref_ms_per_iteration=single_loops[
                               (method, "xla", "mixed_v3")]
                           / ref.iterations * 1e3,
                           busy_share=busy_ms / 1e3 / again_s,
                           all_reduce_per_iteration=(counts["all_reduce"]
                                                     - per_it[1]) / its,
                           collectives=counts)
                out[method] = row
                log(f"  {method}: world size 1 (one shard of "
                    f"{part.rows_per_shard} rows: no neighbour, no halo; "
                    f"halo_width {part.halo_width}), comm {solver.comm}: "
                    f"{its} iterations (phase 6 {ref.iterations}), rr "
                    f"{rr:.3e}, true residual {res:.2e}, max |Δx| {dx:.2e} "
                    f"of max |x| {scale:.3e}; {call_s:.3f} s, again "
                    f"{again_s:.3f} s = {row['ms_per_iteration']:.3f} "
                    f"ms/iteration (phase 6's jpcg_solve xla loop "
                    f"{row['ref_ms_per_iteration']:.3f}), repeat ≡ bit for "
                    f"bit; {row['all_reduce_per_iteration']:.0f} all-reduce"
                    f"(s)/iteration, collectives {counts}; device busy "
                    f"{busy_ms / its:.3f} ms/iteration over its first "
                    f"{PROFILE_TICKS} = {row['busy_share']:.1%} "
                    f"({wall:.3f} s profiled)")
        finally:
            dist.destroy_process_group()
    return out


# -------------------------------------------------------------- phase 7
#: a bf16 output is held to one bf16 ulp of the plain version's (an ulp is
#: 2^-8 to 2^-7 of |want|), plus a floor for values near 0
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4
ARCH = "gemma3-1b"
#: phases 8-10 run gemma3-1b at full width with its depth cut to 6 of 26
#: layers (5 local, then the first global one: both kinds of layer, the
#: 512-slot ring and the full cache) so the smoke keeps its time limit with
#: phase 11; 463,026,816 parameters
GEMMA_LAYERS, GEMMA_PARAMS = 6, 463_026_816


def gemma_config():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH), n_layers=GEMMA_LAYERS)
#: (label, BH, S, T, D, causal, window, dtype, logit scale, tolerance);
#: the first four are gemma3-1b's attention at S = 4,096 (B = 2 × 4 heads,
#: the kv head repeated): global layers causal, local layers window 512.
#: An fp32 case's tolerance holds its output against the plain version; a
#: bf16 case is held within one bf16 ulp, and its tolerance (the fp32
#: one of its shape: 1e-4 at gemma's, 2e-5 at the reference test's) holds
#: the kernel's fp32 output before rounding (bf16 in, fp32 out) against
#: the plain version on the widened inputs.  d20: D % 8 != 0, the
#: ``mma_sync`` kernel's element-wise loads; every other bf16 case takes
#: ``wgmma``; d128: llama4-scout's head dim.  The fp32 cases with D > 32
#: take ``tf32x3`` (d36: D padded to 64); D ≤ 32 (``_route``'s carve-out
#: for the ×30 logits), d42 (D % 4 != 0) and ``/offset`` (q, k and v views
#: one element past a 16-byte boundary) keep the CUDA-core kernel held.
#: The ten before the last three are the ``wgmma`` kernel's edges: S and T
#: off its tiles (the tensor maps' zero fill past T and the rows past S not
#: written), T below one tile, D rounded up to 64, 128 or 256 (8, 16, 32,
#: 136), windows across tiles.  The last three hold the two fp32 kernels'
#: split (appended, so every earlier case keeps its seed, 70 + its index).
FLASH_CASES = (
    ("gemma/global/bf16", 8, 4096, 4096, 256, True, None, "bfloat16", 1, 1e-4),
    ("gemma/local/bf16", 8, 4096, 4096, 256, True, 512, "bfloat16", 1, 1e-4),
    ("gemma/global/fp32", 8, 4096, 4096, 256, True, None, "float32", 1, 1e-4),
    ("gemma/local/fp32", 8, 4096, 4096, 256, True, 512, "float32", 1, 1e-4),
    ("causal/d64", 2, 512, 512, 64, True, None, "float32", 1, 2e-5),
    ("window32/d32", 2, 256, 256, 32, True, 32, "float32", 1, 2e-5),
    ("window128/d32", 2, 256, 256, 32, True, 128, "float32", 1, 2e-5),
    ("noncausal/s128-t256", 1, 128, 256, 64, False, None, "float32", 1, 2e-5),
    ("noncausal/s128-t256/bf16", 1, 128, 256, 64, False, None, "bfloat16", 1,
     2e-5),
    ("bf16/d64", 2, 256, 256, 64, True, None, "bfloat16", 1, 2e-5),
    ("logits-x30/d32", 1, 128, 128, 32, True, None, "float32", 30, 1e-4),
    ("d16", 2, 128, 128, 16, True, None, "float32", 1, 2e-5),
    ("d20/bf16", 1, 128, 128, 20, True, None, "bfloat16", 1, 2e-5),
    ("d120/window48", 2, 256, 256, 120, True, 48, "float32", 1, 2e-5),
    ("d120/window48/bf16", 2, 256, 256, 120, True, 48, "bfloat16", 1, 2e-5),
    ("d128/bf16", 2, 512, 512, 128, True, None, "bfloat16", 1, 2e-5),
    ("ragged/s200-t333/bf16", 2, 200, 333, 64, False, None, "bfloat16", 1,
     2e-5),
    ("causal/s1500/bf16", 2, 1500, 1500, 64, True, None, "bfloat16", 1, 2e-5),
    ("t28/bf16", 1, 128, 28, 64, False, None, "bfloat16", 1, 2e-5),
    ("d8/bf16", 1, 128, 128, 8, True, None, "bfloat16", 1, 2e-5),
    ("d16/window48/bf16", 2, 128, 128, 16, True, 48, "bfloat16", 1, 2e-5),
    ("d32/window32/bf16", 2, 256, 256, 32, True, 32, "bfloat16", 1, 2e-5),
    ("d136/bf16", 1, 256, 256, 136, True, None, "bfloat16", 1, 2e-5),
    ("d256/bf16", 2, 512, 512, 256, True, None, "bfloat16", 1, 2e-5),
    ("d256/window100/bf16", 2, 512, 512, 256, True, 100, "bfloat16", 1, 2e-5),
    ("d256/s300-t700/bf16", 1, 300, 700, 256, False, None, "bfloat16", 1,
     2e-5),    ("d36/window48", 2, 128, 128, 36, True, 48, "float32", 1, 2e-5),
    ("d42", 2, 128, 128, 42, True, None, "float32", 1, 2e-5),
    ("causal/d64/offset", 2, 512, 512, 64, True, None, "float32", 1, 2e-5),
)
#: the per-sequence prefill_32k shape, timed (plus the comparisons, at
#: gemma's fp32 tolerance for the bf16-in, fp32-out check)
FLASH_LONG = (("prefill32k/global/bf16", 4, 32768, True, None),
              ("prefill32k/local/bf16", 4, 32768, True, 512))
FLASH_LONG_TOL = 1e-4
#: exponentials a second on the H100 (MUFU; the FlashAttention-3 paper,
#: arXiv:2407.08608): one a live pair is a floor logged beside the bound,
#: not folded into it
EXP_RATE = 3.9e12


def live_pairs(s: int, t: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps for one head, positions of q and
    k both from 0: the work of a kernel that skips masked pairs."""
    import numpy as np
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(i - window + 1, 0) if window is not None \
        else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _qkv(bh, s, t, d, dtype, scale, dev, seed):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((bh, n, d), generator=gen, device=dev)
               for n in (s, t, t))
    return (scale * q).to(dtype), (scale * k).to(dtype), v.to(dtype)


def _sdpa(q, k, v, causal, window):
    """The library yardstick: PyTorch's fused attention on the same
    inputs, ``is_causal`` or a boolean mask (never called by the port)."""
    import torch
    import torch.nn.functional as F
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal)
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = (j > i - window) & ((j <= i) if causal else True)
    return lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                  attn_mask=mask)


def _flash_bound(q, k, v, causal, window, route=None) -> dict:
    """The least time of ``route``'s work (None: the route ``_route``
    picks).  Bytes: q, k, v read once, o written once (``tf32x3``'s
    pre-pass scratch is a choice of its design, not work of the function,
    and is logged apart).  Operations, per live pair: bf16 inputs take q·k
    (2·D flops, exact in fp32) and p·v twice (p carried to 16 bits as two
    bf16 passes) at the bf16 tensor-core peak; fp32 inputs on ``tf32x3``
    take both products (4·D) as three TF32 products each at the TF32
    tensor-core peak, and on the CUDA-core kernel (``fp32``) once at the
    fp32 CUDA-core peak."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.roofline.model import H100
    route = FA._route(q, k, v) if route is None else route
    bh, s, d = q.shape
    pairs = live_pairs(s, k.shape[1], causal, window) * bh
    flops = 2 * d * pairs
    if route in ("wgmma", "mma_sync"):
        t_ops = 3 * flops / H100.peak_flops("bf16") * 1e3
    elif route == "tf32x3":
        t_ops = 3 * 2 * flops / H100.peak_flops("tf32") * 1e3
    else:
        t_ops = 2 * flops / H100.peak_flops("fp32") * 1e3
    t_bytes = (2 * nbytes(q) + nbytes(k, v)) / H100.hbm_bw * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                pairs=pairs)


def _share(label, bound, ms) -> float:
    """The share of its bound a time reaches; over SHARE_MAX fails."""
    share = bound / ms
    if share > SHARE_MAX:
        raise AssertionError(f"{label}: {ms} ms is {share:.1%} of its bound "
                             f"{bound} ms; the bound or the timing is wrong")
    return share


def _flash_held(label, q, k, v, kw, tol, route=None) -> tuple:
    """Hold the kernel's output against its plain version: fp32 within
    ``tol``; bf16 within one bf16 ulp of |want| (``BF16_RTOL``, floor
    ``BF16_ATOL``), and the bf16 kernel's fp32 output before rounding
    (bf16 in, fp32 out) within ``tol`` of the plain version on the widened
    inputs.  ``route`` forces a kernel (``flash_attn._flash_attention_route``;
    None: the public entry, whose route ``_route`` picks).  Returns max |Δ|
    of the output, and of that fp32 check (None for fp32 inputs)."""
    import torch
    from repro_torch.kernels import flash_attn as FA
    mask = dict(causal=kw["causal"], window=kw["window"])
    got = (FA.flash_attention(q, k, v, **kw) if route is None
           else FA._flash_attention_route(q, k, v, route, **mask))
    want = FA.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if got.dtype != want.dtype or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_attention {label}: dtype {got.dtype}, "
                             f"finite {bool(torch.isfinite(got).all())}")
    if q.dtype != torch.bfloat16:
        if not torch.allclose(got, want, atol=tol, rtol=tol):
            raise AssertionError(f"flash_attention {label}: differs from its "
                                 f"plain version beyond {tol} (max |Δ| "
                                 f"{err})")
        return err, None
    over = diff - (BF16_RTOL * want.float().abs() + BF16_ATOL)
    if bool((over > 0).any()):
        raise AssertionError(f"flash_attention {label}: differs from its "
                             f"plain version by more than one bf16 ulp "
                             f"(max |Δ| {err}, worst excess "
                             f"{float(over.max())}; {_where(over)})")
    del got, want, diff, over
    wide = FA._flash_attention_route(q, k, v, route, wide=True, **mask)
    want = FA.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    wide_err = float((wide - want).abs().max())
    if wide.dtype != torch.float32 or not torch.allclose(
            wide, want, atol=tol, rtol=tol):
        over = (wide - want).abs() - tol * (1 + want.abs())
        raise AssertionError(f"flash_attention {label}: bf16 in, fp32 out "
                             f"differs from the plain version on the "
                             f"widened inputs beyond {tol} (max |Δ| "
                             f"{wide_err}; {_where(over)})")
    return err, wide_err


def _where(excess) -> str:
    """Where an error over its gate lies: the count of elements over it,
    the first one's (head, row, column), and the share of heads, 16-row
    groups and 8-column groups that hold any (a layout fault shows as a
    pattern)."""
    bad = excess > 0
    n = int(bad.sum())
    if not n:
        return "none over"
    first = [int(i) for i in bad.nonzero()[0]]
    bh, s, d = bad.shape
    rows = bad.any(0).any(1)
    cols = bad.any(0).any(0)
    row16 = rows[: s // 16 * 16].view(-1, 16).any(1) if s >= 16 else rows
    col8 = cols[: d // 8 * 8].view(-1, 8).any(1) if d >= 8 else cols
    return (f"{n} of {bad.numel()} over; first at {first}; heads "
            f"{int(bad.any(2).any(1).sum())}/{bh}, 16-row groups "
            f"{int(row16.sum())}/{row16.numel()}, 8-column groups "
            f"{int(col8.sum())}/{col8.numel()} "
            f"(columns {[int(c) for c in cols.nonzero()[:16, 0]]})")


def _held_text(tol, wide_err) -> str:
    if wide_err is None:
        return f"within {tol}"
    return (f"within 1 bf16 ulp; bf16 in, fp32 out within {tol} "
            f"(max |Δ| {wide_err:.3e})")


def _want_route(q, k, v) -> str:
    """The route each input of the smoke must take: on 16-byte aligned
    bases, bf16 with D % 8 == 0 ``wgmma`` and fp32 with D % 4 == 0 and
    D > 32 (past ``_route``'s carve-out for the ×30-logit case)
    ``tf32x3``; other bf16 ``mma_sync``, other fp32 ``fp32``."""
    import torch
    d = q.shape[2]
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        return "wgmma" if aligned and d % 8 == 0 else "mma_sync"
    return "tf32x3" if aligned and d % 4 == 0 and d > 32 else "fp32"


def _off16(x):
    """x's values in a view one element past a 16-byte boundary."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def _flash_routed(label, q, k, v, kw, tol) -> tuple:
    """:func:`_flash_held` through the public entry, with the route its
    launches counted (``flash_attn.LAUNCHES`` by route), which must be
    :func:`_want_route`'s.  Returns (max |Δ|, wide max |Δ|, route)."""
    from repro_torch.kernels import flash_attn as FA
    before = dict(FA.LAUNCHES)
    err, wide_err = _flash_held(label, q, k, v, kw, tol)
    routes = [r for r in FA.ROUTES if FA.LAUNCHES[f"flash_attention[{r}]"]
              > before[f"flash_attention[{r}]"]]
    if routes != [_want_route(q, k, v)]:
        raise AssertionError(f"flash_attention {label}: launched on routes "
                             f"{routes}, not {_want_route(q, k, v)}")
    return err, wide_err, routes[0]


#: each route of the main path and the other kernel of its dtype, which the
#: A/B forces on the same inputs
PARTNER = {"wgmma": "mma_sync", "tf32x3": "fp32"}


def _flash_ab(label, q, k, v, kw, tol, long=False) -> dict:
    """A shape of the main path on both kernels of its dtype: the partner
    route (``PARTNER``) held as the picked one was (forced route), then
    both timed in turns (picked, partner, partner, picked; the faster of
    each pair), beside the plain version, SDPA, each route's own bound and
    the exponential floor (live pairs at ``EXP_RATE``).  ``long``: few
    repetitions (the 32k shapes).  On ``tf32x3`` also its pre-pass's
    scratch bytes (:func:`_tf32_prepass`)."""
    from repro_torch.kernels import flash_attn as FA
    mask = dict(causal=kw["causal"], window=kw["window"])
    picked = FA._route(q, k, v)
    partner = PARTNER[picked]
    err_p, wide_p = _flash_held(f"{label} [{partner}]", q, k, v, kw, tol,
                                route=partner)
    runs = {picked: lambda: FA.flash_attention(q, k, v, **kw),
            partner: lambda: FA._flash_attention_route(q, k, v, partner,
                                                       **mask)}
    if long:
        def timer(fn):
            return cuda_ms(fn, reps=3, warm=1)
    else:
        timer = median_ms
    ms = {picked: [], partner: []}
    for name in (picked, partner, partner, picked):
        ms[name].append(timer(runs[name]))
    t_k, t_p = min(ms[picked]), min(ms[partner])
    if long:
        t_plain = cuda_ms(lambda: FA.flash_attention_plain(q, k, v, **kw),
                          reps=1, warm=0)
        t_l = cuda_ms(_sdpa(q, k, v, kw["causal"], kw["window"]), reps=2,
                      warm=1)
    else:
        t_plain = cuda_ms(lambda: FA.flash_attention_plain(q, k, v, **kw),
                          reps=3)
        t_l = median_ms(_sdpa(q, k, v, kw["causal"], kw["window"]))
    b = _flash_bound(q, k, v, kw["causal"], kw["window"])
    pb = _flash_bound(q, k, v, kw["causal"], kw["window"], partner)
    share = _share(f"flash_attention {label}", b["bound_ms"], t_k)
    p_share = _share(f"flash_attention {label} [{partner}]", pb["bound_ms"],
                     t_p)
    r = dict(ms=t_k, partner=partner, partner_ms=t_p, plain_ms=t_plain,
             library_ms=t_l, share=share, partner_share=p_share,
             partner_bound_ms=pb["bound_ms"], partner_bound_by=pb["bound_by"],
             partner_err=err_p, partner_wide_err=wide_p, faster=t_k < t_p,
             exp_floor_ms=b["pairs"] / EXP_RATE * 1e3, **b)
    if picked == "tf32x3":
        r.update(_tf32_prepass(q, k, runs[picked]))
    return r


def _tf32_prepass(q, k, run) -> dict:
    """``tf32x3``'s pre-pass beside its bound, not in it: the bytes of its
    scratch (split K and Vᵀ written once and read once), those bytes' time
    at the HBM rate, and the route's device time split into the pre-pass
    (``split_kv``) and the main kernel (``flash_fwd_tf32``) by the
    profiler over 20 calls between two runs of 2,000 elementwise kernels
    (late in the smoke a window loses kernels at its ends): a kernel's
    mean over the launches the window kept, None if it kept none."""
    import torch
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.roofline.model import H100
    pad = torch.zeros(1, device=q.device)

    def window():
        for _ in range(2000):
            pad.add_(1.0)
        for _ in range(20):
            run()
        for _ in range(2000):
            pad.add_(1.0)

    _, _, ev = device_profile(window)
    split = {}
    for part, name in (("prepass_ms", "split_kv"),
                       ("main_ms", "flash_fwd_tf32")):
        n = sum(c for key, _, c in ev if name in key)
        split[part] = sum(t for key, t, _ in ev if name in key) / n if n \
            else None
    moved = 2 * 4 * FA._tf32_tiles(q.shape[0], k.shape[1], q.shape[2])
    return dict(split, prepass_bytes=moved,
                prepass_bytes_ms=moved / H100.hbm_bw * 1e3)


def _flash_alone(label, shape, q, k, v, kw, tol) -> dict:
    """A composed shape's kernel alone: held on the route ``_route`` picks,
    and A/B against the other kernel of its dtype (:func:`_flash_ab`);
    logged.  Returns its row."""
    err, wide_err, route = _flash_routed(label, q, k, v, kw, tol)
    r = _flash_ab(label, q, k, v, kw, tol)
    log(f"  flash {shape} ({label}) [{route}]: {_held_text(tol, wide_err)} "
        f"(max |Δ| {err:.3e}); {_ab_text(route, r)}")
    return dict(r, shape=shape, max_abs_err=err, wide_err=wide_err,
                route=route)


def _ab_text(route, r) -> str:
    """One A/B row as text: each route against its own bound, and
    ``tf32x3``'s pre-pass beside its bound."""
    extra = ""
    if "prepass_bytes" in r:
        prof = ("not profiled: the window kept no launch"
                if r["prepass_ms"] is None or r["main_ms"] is None else
                f"profiled {r['prepass_ms']:.4f} + main {r['main_ms']:.4f}")
        extra = (f"; pre-pass, not in the bound: {r['prepass_bytes']} B of "
                 f"scratch ({r['prepass_bytes_ms']:.4f} ms at the HBM "
                 f"rate), {prof}")
    partner = r["partner"]
    return (f"{route} {r['ms']:.4f} ms ({r['share']:.1%} of its bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}{extra}), {partner} "
            f"{r['partner_ms']:.4f} ({r['partner_share']:.1%} of its bound "
            f"{r['partner_bound_ms']:.4f} by {r['partner_bound_by']}; held, "
            f"max |Δ| {r['partner_err']:.3e}), plain {r['plain_ms']:.3f}, "
            f"SDPA {r['library_ms']:.4f}; exp floor {r['exp_floor_ms']:.4f} "
            f"ms ({r['pairs']} live pairs); {route} "
            f"{'faster' if r['faster'] else 'NOT faster'}")


def phase_flash(dev):
    """flash_attention against its plain version on the card, within the
    stated tolerance, at gemma3-1b's shapes and the reference test's, each
    on the route ``_route`` picks (logged from the launch counts); the bf16
    shapes of the main path also on the ``mma_sync`` kernel, and both
    timed beside the plain version, SDPA, the bound and the exponential
    floor; the fp32 ones likewise on both fp32 kernels.  Returns the head
    row, every timed row and max |Δ| by route."""
    import torch
    from repro_torch.kernels import flash_attn as FA
    errs, timed = {r: [] for r in FA.ROUTES}, {}
    for n, (label, bh, s, t, d, causal, window, dt, scale, tol) in \
            enumerate(FLASH_CASES):
        q, k, v = _qkv(bh, s, t, d, getattr(torch, dt), scale, dev, 70 + n)
        if label.endswith("/offset"):
            q, k, v = (_off16(x) for x in (q, k, v))
        # one block of each: the reference's contract for ragged S and T
        # (the kernels pick their own tiles)
        kw = dict(causal=causal, window=window, block_q=s, block_k=t)
        err, wide_err, route = _flash_routed(label, q, k, v, kw, tol)
        errs[route].append(err)
        line = (f"  flash {label:26s} BH={bh} S={s} T={t} D={d} [{route}]: "
                f"{_held_text(tol, wide_err)} (max |Δ| {err:.3e})")
        if label.startswith("gemma/"):
            r = _flash_ab(label, q, k, v, kw, tol)
            errs[r["partner"]].append(r["partner_err"])
            timed[label] = dict(r, max_abs_err=err, wide_err=wide_err,
                                route=route)
            line += "; " + _ab_text(route, r)
        log(line)
        del q, k, v
        torch.cuda.empty_cache()
    for label, bh, s, causal, window in FLASH_LONG:
        q, k, v = _qkv(bh, s, s, 256, torch.bfloat16, 1, dev, 90)
        kw = dict(causal=causal, window=window)
        err, wide_err, route = _flash_routed(label, q, k, v, kw,
                                             FLASH_LONG_TOL)
        errs[route].append(err)
        torch.cuda.empty_cache()
        r = _flash_ab(label, q, k, v, kw, FLASH_LONG_TOL, long=True)
        errs[r["partner"]].append(r["partner_err"])
        timed[label] = dict(r, wide_err=wide_err, route=route)
        log(f"  flash {label:26s} BH={bh} S={s} D=256 [{route}]: "
            f"{_held_text(FLASH_LONG_TOL, wide_err)} (max |Δ| "
            f"{err:.3e}); {_ab_text(route, r)}")
        del q, k, v
        torch.cuda.empty_cache()
    err_by_route = {r: max(e) for r, e in errs.items()}
    head = dict(timed["gemma/global/bf16"],
                max_abs_err=max(err_by_route.values()),
                shape="BH=8 S=T=4096 D=256 bf16 causal")
    return head, timed, err_by_route


#: the flash kernels by route, each an entry of the ``kernels`` line
FLASH_ROUTES = ("flash_attention[wgmma]", "flash_attention[mma_sync]",
                "flash_attention[tf32x3]", "flash_attention[fp32]")
#: what the LM paths launch: the bf16 compositions take ``wgmma``, the fp32
#: ones ``tf32x3``; no model's head dim takes ``mma_sync`` or ``fp32``
FLASH_PATH = ("flash_attention", "flash_attention[wgmma]",
              "flash_attention[tf32x3]")


def flash_entries(head, timed, err_by_route) -> dict:
    """The ``kernels`` line's rows of the flash routes from phase 7: the
    bf16 kernels at gemma3-1b's global shape (``wgmma`` is the head row,
    ``mma_sync`` its A/B partner on the same inputs), the fp32 kernels at
    the same shape in fp32 (``tf32x3``, and the CUDA-core ``fp32`` kernel
    on the same inputs, each with its own bound)."""
    fp32 = dict(timed["gemma/global/fp32"],
                shape="BH=8 S=T=4096 D=256 fp32 causal")
    rows = {}
    for row in (head, fp32):
        route, partner = row["route"], row["partner"]
        rows[f"flash_attention[{route}]"] = dict(
            row, max_abs_err=err_by_route[route])
        rows[f"flash_attention[{partner}]"] = dict(
            {k: row[k] for k in ("plain_ms", "library_ms", "shape")},
            ms=row["partner_ms"], bound_ms=row["partner_bound_ms"],
            bound_by=row["partner_bound_by"],
            max_abs_err=err_by_route[partner])
    return rows


# -------------------------------------------------------------- phase 8
LM_SEQ = 8192                       # ≥ CHUNKED_ABOVE: the Q-chunked path
COMPOSE_SEQ, COMPOSE_BATCH = 4096, 2
COMPOSE_LAYERS = (0, 5)             # local (window 512), global


def _compose(lp, x, cfg, window):
    """``attention()`` rebuilt around the kernel, as the reference's
    ``test_matches_model_attention``: dense → RoPE → kv heads repeated →
    head-major ``flash_attention`` → ``wo``."""
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = A._split_heads(L.dense(lp.attn.wq, x), h, hd)
    k = A._split_heads(L.dense(lp.attn.wk, x), hk, hd)
    v = A._split_heads(L.dense(lp.attn.wv, x), hk, hd)
    cos, sin = L.rope_freqs(torch.arange(s, device=x.device)[None], hd,
                            cfg.rope_theta)
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    k, v = A._repeat_kv(k, h), A._repeat_kv(v, h)
    qh, kh, vh = (t.permute(0, 2, 1, 3).reshape(b * h, s, hd).contiguous()
                  for t in (q, k, v))
    o = flash_attention(qh, kh, vh, causal=True, window=window)
    o = o.reshape(b, h, s, hd).permute(0, 2, 1, 3).reshape(b, s, h * hd)
    return L.dense(lp.attn.wo, o)


def phase_lm_forward(dev):
    """gemma3-1b at full width: parameters on the card from a seeded
    generator, the count checked; ``forward_logits(last_only=True)`` at
    S = 8,192; the kernel composed into layers 0 and 5 against
    ``attention()`` at fp32 and bf16 compute."""
    import dataclasses
    import torch
    from repro_torch.models import count_params, forward_logits, init_params
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import dtype_of, layer_windows

    cfg = gemma_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = count_params(params)
    if n != cfg.param_count() or n != GEMMA_PARAMS:
        raise AssertionError(f"{ARCH}: {n} parameters, config says "
                             f"{cfg.param_count()}")
    log(f"  init_params: {n} parameters (= param_count()), "
        f"{sum(nbytes(p) for p in params.parameters())} B fp32, "
        f"{init_s:.2f} s")
    gen = torch.Generator().manual_seed(8)
    tokens = torch.randint(0, cfg.vocab, (1, LM_SEQ), generator=gen).to(dev)
    fwd = lambda: forward_logits(params, cfg, {"tokens": tokens},
                                 last_only=True)
    torch.cuda.reset_peak_memory_stats()
    logits = fwd()
    torch.cuda.synchronize()
    if logits.shape != (1, 1, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"forward_logits: shape {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    walls = []
    for _ in range(3):
        _, w = _single(fwd)
        walls.append(w)
    fwd_s = min(walls)
    peak = torch.cuda.max_memory_allocated()
    log(f"  forward_logits(last_only) B=1 S={LM_SEQ} {cfg.dtype}: "
        f"{fwd_s * 1e3:.1f} ms (of {[round(w * 1e3, 1) for w in walls]}) = "
        f"{LM_SEQ / fwd_s:.0f} tokens/s; peak {peak / 2**30:.2f} GiB")
    cell = _cell(ARCH, f"prefill B1xS{LM_SEQ}", "prefill",
                 cfg.active_param_count(), 1, LM_SEQ, fwd, fwd_s * 1e3)

    gen = torch.Generator().manual_seed(9)
    tokens = torch.randint(0, cfg.vocab, (COMPOSE_BATCH, COMPOSE_SEQ),
                           generator=gen).to(dev)
    windows = layer_windows(cfg)
    worst = {}
    for dt, tol in (("float32", 2e-4), ("bfloat16", 3e-2)):
        c = dataclasses.replace(cfg, dtype=dt)
        for l in COMPOSE_LAYERS:
            lp = params.layers[l]
            x = L.rmsnorm(lp.ln1, L.embed(params.embed, tokens,
                                          dtype_of(dt)), cfg.norm_eps)
            want = A.attention(lp.attn, x, n_heads=c.n_heads,
                               n_kv_heads=c.n_kv_heads, head_dim=c.hd,
                               window=windows[l], rope_theta=c.rope_theta)
            got = _compose(lp, x, c, windows[l])
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            worst[f"layer{l}/{dt}"] = err
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
                raise AssertionError(f"layer {l} {dt}: flash composition "
                                     f"differs from attention() (max |Δ| "
                                     f"{err}, tolerance {tol})")
            log(f"  layer {l} (window {windows[l]}) {dt}: dense → RoPE → "
                f"flash_attention → wo ≡ attention() within {tol} (max |Δ| "
                f"{err:.3e}; |y| max {float(want.abs().max()):.3e})")
    del logits
    return params, dict(forward_ms=fwd_s * 1e3, tokens_per_s=LM_SEQ / fwd_s,
                        init_s=init_s, peak_bytes=peak, compose=worst,
                        cell=cell)


# -------------------------------------------------------------- phase 9
ENGINE_PROMPTS = 10                 # of 8-64 tokens, plus one of 600
LONG_PROMPT = 600                   # > the 512-slot ring of the local layers
MAX_NEW = 32
FP32_CONTINUATION = 8


def _drive(eng, prompts, max_new, audio=None):
    """Admit as slots free and tick until every request is done; host-clock
    times of admission (prefill) and of the ticks, each of which ends in a
    host read of its tokens.  ``audio``: each request's frame embeddings
    (an encoder-decoder engine)."""
    pending = list(enumerate(prompts))
    owner, outs = {}, {}
    prefill_s = tick_s = 0.0
    ticks = 0
    while pending or eng.active.any():
        while pending and (~eng.active).any():
            rid, prompt = pending.pop(0)
            kw = {} if audio is None else {"audio_embeds": audio[rid]}
            t0 = time.perf_counter()
            owner[eng.add_request(prompt, max_new=max_new, **kw)] = rid
            prefill_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        out = eng.step()
        tick_s += time.perf_counter() - t0
        ticks += 1
        for slot in out:
            if not eng.active[slot]:
                outs[owner[slot]] = list(eng.outputs[slot])
    return outs, dict(prefill_s=prefill_s, tick_s=tick_s, ticks=ticks)


def phase_engine_lm(params, dev):
    """DecodeEngine on gemma3-1b at full width: bf16 (the published compute
    and cache dtype) over 11 requests with mid-flight admission; then fp32,
    whose greedy continuation must equal the teacher-forced rollout."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import forward_logits
    from repro_torch.serve import DecodeEngine, EngineConfig, bytes_per_slot

    cfg = gemma_config()
    rng = np.random.default_rng(10)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, int(n))]
               for n in rng.integers(8, 65, ENGINE_PROMPTS)]
    prompts.append([int(t) for t in rng.integers(1, cfg.vocab,
                                                 LONG_PROMPT)])
    ecfg = EngineConfig(device=str(dev))
    eng = DecodeEngine(cfg, params, ecfg)
    outs, t = _drive(eng, prompts, MAX_NEW)
    n_prompt = sum(len(p) for p in prompts)
    n_tick_tokens = sum(len(o) - 1 for o in outs.values())
    if sorted(outs) != list(range(len(prompts))) or any(
            len(o) != MAX_NEW for o in outs.values()):
        raise AssertionError(f"engine: outputs {[len(o) for o in outs.values()]}")
    ms_tick = t["tick_s"] / t["ticks"] * 1e3
    row = dict(requests=len(prompts), prompt_tokens=n_prompt,
               prefill_ms_per_token=t["prefill_s"] / n_prompt * 1e3,
               ms_per_tick=ms_tick, ticks=t["ticks"],
               decode_tokens_per_s=n_tick_tokens / t["tick_s"],
               tokens_per_s=sum(map(len, outs.values()))
               / (t["prefill_s"] + t["tick_s"]),
               cache_bytes_per_slot=bytes_per_slot(cfg, ecfg.max_len))
    # device-busy share of the tick, over one window: a few profiled ticks
    # of a full engine (every tick decodes all 8 slots), their device time
    # over their own wall time
    for p in prompts[:ecfg.batch_slots]:
        eng.add_request(p[:8], max_new=MAX_NEW)
    n_prof = 8
    _, wall, ev = device_profile(lambda: [eng.step() for _ in range(n_prof)])
    busy = sum(ms for _, ms, _ in ev) / n_prof
    prof_tick = wall / n_prof * 1e3
    row.update(busy_ms_per_tick=busy, busy_share=busy / prof_tick,
               profiled_ms_per_tick=prof_tick,
               kernels_per_tick=sum(c for _, _, c in ev) / n_prof)
    log(f"  bf16 engine: {row['requests']} requests ({n_prompt} prompt "
        f"tokens, one of {LONG_PROMPT}), {t['ticks']} ticks of "
        f"{ecfg.batch_slots} slots: prefill {row['prefill_ms_per_token']:.2f} "
        f"ms/token, {ms_tick:.2f} ms/tick = {row['decode_tokens_per_s']:.0f} "
        f"decode tokens/s ({row['tokens_per_s']:.0f} tokens/s with "
        f"prefill); {n_prof} profiled ticks: device busy {busy:.2f} ms of "
        f"{prof_tick:.2f} ms/tick = {busy / prof_tick:.1%}, "
        f"{row['kernels_per_tick']:.0f} kernels/tick;"
        f" cache {row['cache_bytes_per_slot']} B/slot")
    for key, ms, c in sorted(ev, key=lambda e: -e[1])[:6]:
        log(f"      {ms:9.2f} ms {c:6d}x  {key[:80]}")
    row["cell"] = _cell(ARCH, f"decode tick B{ecfg.batch_slots}", "decode",
                        cfg.active_param_count(), ecfg.batch_slots, 1,
                        eng.step, ms_tick)

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    eng32 = DecodeEngine(cfg32, params, EngineConfig(
        batch_slots=2, cache_dtype="float32", device=str(dev)))
    short, long_ = prompts[0], prompts[-1]
    outs32, _ = _drive(eng32, [short, long_], FP32_CONTINUATION)
    seq, want = list(short), []
    for _ in range(FP32_CONTINUATION):
        lg = forward_logits(params, cfg32, {"tokens": torch.tensor(
            [seq], device=dev)}, last_only=True)
        want.append(int(torch.argmax(lg[0, -1])))
        seq.append(want[-1])
    if outs32[0] != want:
        raise AssertionError(f"fp32 engine {outs32[0]} != rollout {want}")
    first = int(torch.argmax(forward_logits(params, cfg32, {
        "tokens": torch.tensor([long_], device=dev)}, last_only=True)[0, -1]))
    if outs32[1][0] != first:
        raise AssertionError(f"fp32 engine's first token after the "
                             f"{LONG_PROMPT}-token prompt {outs32[1][0]} != "
                             f"forward's argmax {first}")
    pairs = [(a, b) for rid in (0, len(prompts) - 1)
             for a, b in zip(outs[rid], outs32[0 if rid == 0 else 1])]
    row["bf16_fp32_agreement"] = sum(a == b for a, b in pairs) / len(pairs)
    log(f"  fp32 engine: {FP32_CONTINUATION}-token greedy continuation == "
        f"teacher-forced rollout; first token after {LONG_PROMPT} tokens == "
        f"forward's argmax; bf16 agrees with fp32 on "
        f"{row['bf16_fp32_agreement']:.1%} of {len(pairs)} tokens")
    return row


# ------------------------------------------------------------- phase 10
TRAIN_BATCH, TRAIN_SEQ = 8, 128
ADAMW_STEPS, CKPT_AT = 4, 2
CGGN_STEPS = 2
#: the microbatch step against the full batch: both run the blocks in bf16,
#: on matmuls of other row counts (cuBLAS picks its kernels by shape), so
#: the two round different products; the loss to rel 1e-3 and the
#: gradients to ‖Δ‖ ≤ 3e-2 ‖g‖ (a few bf16 ulps, 2⁻⁸ each)
MICRO_LOSS_RTOL, MICRO_GRAD_RTOL = 1e-3, 3e-2
MATVEC_REPS = 3


def _gib(b: int) -> str:
    return f"{b / 2**30:.2f} GiB"


def phase_train(dev):
    """The training path at gemma3-1b's full width (bf16 compute, fp32
    parameters, ``remat``): a ``Trainer`` with AdamW (bf16 moments) for 4
    steps, checkpointed at step 2 and resumed into fresh parameters, steps
    3–4 bit for bit; the gradients of 2 strided microbatches against the
    full batch, and one ``microbatches=2`` step; 2 CGGN steps through the
    launcher's ``cggn_lm_step`` (cg_iters 8, 4 probes, ``tpu_fp32``), the
    first refreshing the diagonal; the GGN matvec timed and profiled."""
    import math
    import tempfile
    import torch
    from repro_torch.core.gn import make_ggn_matvec
    from repro_torch.launch.train import CGGN_CONFIG, cggn_lm_step, lm_ggn_fns
    from repro_torch.models import count_params, init_params
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                                   Trainer, TrainerConfig, adamw_init,
                                   cggn_init, make_train_step)
    from repro_torch.train.loop import loss_and_grads

    cfg = gemma_config()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0),
                       device=dev)
    opt = AdamWConfig(lr=3e-3)                        # launcher's default
    step_fn = make_train_step(cfg, opt=opt, device=dev)
    row = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, dtype=cfg.dtype,
               remat=cfg.remat)

    def trainer(seed, ckpt_dir):
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed),
                             device=dev)
        return Trainer(cfg, data, step_fn, params, adamw_init(params, opt),
                       TrainerConfig(total_steps=ADAMW_STEPS, ckpt_every=0,
                                     ckpt_dir=ckpt_dir, log_every=0),
                       torch.Generator().manual_seed(seed))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        tr = trainer(0, tmp)
        n = count_params(tr.params)
        if n != cfg.param_count():
            raise AssertionError(f"{ARCH}: {n} parameters, config says "
                                 f"{cfg.param_count()}")
        tr.run(CKPT_AT)
        t0 = time.perf_counter()
        tr.save()
        save_s = time.perf_counter() - t0
        tr.run(ADAMW_STEPS - CKPT_AT)
        torch.cuda.synchronize()
        row["adamw_peak_bytes"] = torch.cuda.max_memory_allocated()
        log_ = tr.metrics_log
        losses = [m["loss"] for m in log_]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"AdamW losses {losses}")
        # step 0 pays the first call's set-up; the rest are steady
        step_ms = [m["step_time_s"] * 1e3 for m in log_]
        ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
        row.update(adamw_losses=losses, adamw_step_ms=step_ms,
                   adamw_ms_per_step=ms, adamw_tokens_per_s=tokens / ms * 1e3,
                   ckpt_save_s=save_s)
        log(f"  AdamW {ADAMW_STEPS} steps, B={TRAIN_BATCH} S={TRAIN_SEQ} "
            f"({n} parameters, bf16 moments): losses "
            f"{[round(v, 4) for v in losses]}; steps "
            f"{[round(v, 1) for v in step_ms]} ms → {ms:.1f} ms/step = "
            f"{tokens / ms * 1e3:.0f} tokens/s; peak "
            f"{_gib(row['adamw_peak_bytes'])}; checkpoint at step {CKPT_AT} "
            f"saved in {save_s:.1f} s")

        tr2 = trainer(1, tmp)                         # other parameters
        t0 = time.perf_counter()
        if not tr2.try_resume() or tr2.step != CKPT_AT:
            raise AssertionError(f"resume: step {tr2.step}")
        row["ckpt_restore_s"] = time.perf_counter() - t0
        tr2.run(ADAMW_STEPS - CKPT_AT)
        resumed = [m["loss"] for m in tr2.metrics_log]
        same = all(torch.equal(a, b) for a, b in
                   zip(tr.params.parameters(), tr2.params.parameters()))
        if resumed != losses[CKPT_AT:] or not same:
            raise AssertionError(
                f"resume from step {CKPT_AT}: losses {resumed} != "
                f"{losses[CKPT_AT:]}, parameters equal: {same}")
        log(f"  resumed from step {CKPT_AT} into fresh parameters (restored "
            f"in {row['ckpt_restore_s']:.1f} s): steps {CKPT_AT}–"
            f"{ADAMW_STEPS - 1} losses {resumed} and every parameter after "
            f"step {ADAMW_STEPS - 1} bit for bit the uninterrupted run's")
    del tr

    # one AdamW step's device-busy share (a real step of tr2)
    batch = data.batch_at(ADAMW_STEPS)
    _, wall, ev = device_profile(lambda: step_fn(
        tr2.params, tr2.opt_state, batch, ADAMW_STEPS))
    busy = sum(t for _, t, _ in ev)
    # the share against the unprofiled step (the profiler slows the
    # launches), and against the profiled one
    row.update(adamw_busy_ms=busy, adamw_profiled_ms=wall * 1e3,
               adamw_busy_share=busy / ms,
               adamw_busy_share_profiled=busy / (wall * 1e3),
               adamw_kernels=sum(c for _, _, c in ev))
    log(f"  one profiled AdamW step: device busy {busy:.1f} ms = "
        f"{busy / ms:.1%} of the {ms:.1f} ms step ({busy / (wall * 1e3):.1%} "
        f"of the {wall * 1e3:.1f} ms profiled), {row['adamw_kernels']} "
        "kernels")
    for key, t, c in sorted(ev, key=lambda e: -e[1])[:6]:
        log(f"      {t:9.2f} ms {c:6d}x  {key[:80]}")
    row["cell"] = _cell(ARCH, f"train B{TRAIN_BATCH}xS{TRAIN_SEQ}", "train",
                        cfg.active_param_count(), TRAIN_BATCH, TRAIN_SEQ,
                        lambda: step_fn(tr2.params, tr2.opt_state, batch,
                                        ADAMW_STEPS), ms)

    # two strided microbatches against the full batch, same parameters
    l1, g1 = loss_and_grads(tr2.params, cfg, batch, 1)
    l2, g2 = loss_and_grads(tr2.params, cfg, batch, 2)
    dl = abs(float(l2) - float(l1)) / abs(float(l1))
    num = sum(float(torch.sum(torch.square(g2[k] - g1[k]))) for k in g1)
    den = sum(float(torch.sum(torch.square(g1[k]))) for k in g1)
    dg = math.sqrt(num / den)
    del g1, g2
    if dl > MICRO_LOSS_RTOL or not dg <= MICRO_GRAD_RTOL:
        raise AssertionError(f"microbatches=2: loss rel {dl:.2e}, grads "
                             f"‖Δ‖/‖g‖ {dg:.2e}")
    step2 = make_train_step(cfg, opt=opt, microbatches=2, device=dev)
    (_, _, m2), wall = _single(lambda: step2(tr2.params, tr2.opt_state,
                                             batch, ADAMW_STEPS + 1))
    row.update(micro_loss_rel=dl, micro_grad_rel=dg,
               micro_step_ms=wall * 1e3)
    log(f"  microbatches=2: loss {float(l2):.6f} vs {float(l1):.6f} (rel "
        f"{dl:.2e} ≤ {MICRO_LOSS_RTOL}), grads ‖Δ‖/‖g‖ {dg:.2e} ≤ "
        f"{MICRO_GRAD_RTOL}; one make_train_step(microbatches=2) step "
        f"{wall * 1e3:.1f} ms, loss {float(m2['loss']):.4f}")
    del tr2, step2

    # CGGN, the launcher's settings
    params = init_params(cfg, torch.Generator(dev).manual_seed(2),
                         device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = cggn_init(params, 0)
    steps = []
    for step in range(CGGN_STEPS):
        (params, state, m), wall = _single(
            lambda: cggn_lm_step(params, state, data.batch_at(step)))
        m = {k: float(v) for k, v in m.items()}
        m["ms"] = wall * 1e3
        steps.append(m)
        if not all(math.isfinite(v) for v in m.values()) or \
                m["delta_norm"] > CGGN_CONFIG.max_delta_norm * (1 + 1e-6):
            raise AssertionError(f"CGGN step {step}: {m}")
        log(f"  CGGN step {step}{' (refreshes the diagonal)' if step == 0 else ''}: "
            f"loss {m['loss']:.4f}, |g| {m['grad_norm']:.4f}, |δ| "
            f"{m['delta_norm']:.4f} (≤ {CGGN_CONFIG.max_delta_norm}), inner "
            f"CG {int(m['cg_iters'])} iterations, {m['ms']:.0f} ms")
    row["cggn_peak_bytes"] = torch.cuda.max_memory_allocated()
    row["cggn_steps"] = steps
    del state

    # the GGN matvec alone: timed, then profiled once
    logits_fn, loss_logits = lm_ggn_fns(params, data.batch_at(0))
    mv, nv = make_ggn_matvec(loss_logits, logits_fn, params,
                             CGGN_CONFIG.damping)
    v = torch.randn(nv, generator=torch.Generator(dev).manual_seed(3),
                    device=dev)
    mv(v)
    walls = [_single(lambda: mv(v))[1] * 1e3 for _ in range(MATVEC_REPS)]
    _, wall, ev = device_profile(lambda: mv(v))
    busy = sum(t for _, t, _ in ev)
    row.update(matvec_ms=min(walls), matvec_ms_all=walls,
               matvec_busy_ms=busy, matvec_profiled_ms=wall * 1e3,
               matvec_busy_share=busy / min(walls),
               matvec_busy_share_profiled=busy / (wall * 1e3),
               matvec_kernels=sum(c for _, _, c in ev))
    log(f"  CGGN: {[round(s['ms']) for s in steps]} ms per step (the first "
        f"with 4 probes, the r0 matvec and {int(steps[0]['cg_iters'])} CG "
        f"iterations); peak {_gib(row['cggn_peak_bytes'])}; one GGN matvec "
        f"{min(walls):.1f} ms (of {[round(w, 1) for w in walls]}); profiled: "
        f"device busy {busy:.1f} ms = {busy / min(walls):.1%} of "
        f"{min(walls):.1f} ms ({busy / (wall * 1e3):.1%} of the "
        f"{wall * 1e3:.1f} ms profiled), {row['matvec_kernels']} kernels")
    for key, t, c in sorted(ev, key=lambda e: -e[1])[:6]:
        log(f"      {t:9.2f} ms {c:6d}x  {key[:80]}")
    del mv, v, params
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------------------ phase 10b
MESH_STEPS = 2


def phase_mesh_train(dev, card):
    """The sharded train step on the card: a (1, 1) ``("data", "model")``
    mesh over a world-size-1 NCCL group (``file://`` rendezvous, as phase
    6c), gemma3-1b at phase 10's width, depth, batch, data and seed-0
    weights.  Two ``make_train_step(cfg, mesh)`` steps (DTensor parameters
    and moments, the batch sharded over ``data``) held bit for bit against
    two unsharded steps: the loss, every parameter and both AdamW moments.
    Then the sharded state is checkpointed (``full_tensor`` on every rank,
    rank 0 writes) and restored unsharded and through ``elastic_restore``
    onto the (1, 1) mesh, bit for bit, its payload byte for byte an
    unsharded save's.  ms/step sharded against unsharded, kernels a step,
    the busy share and the peak memory are logged."""
    import datetime
    import json as _json
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core.gn import param_dict
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                                   adamw_init, make_train_step)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import elastic_restore

    cfg = gemma_config()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0),
                       device=dev)
    opt = AdamWConfig(lr=3e-3)                    # phase 10's settings
    row = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=MESH_STEPS,
               card=card)

    def same(a, b):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
            b.view(torch.int16) if b.dtype == torch.bfloat16 else b)

    def timed_steps(step_fn, params, state):
        losses, ms = [], []
        for s in range(MESH_STEPS):
            (params, state, m), wall = _single(lambda: step_fn(
                params, state, data.batch_at(s), s))
            losses.append(m["loss"].detach().clone())
            ms.append(wall * 1e3)
        return params, state, losses, ms

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            ref = init_params(cfg, torch.Generator(dev).manual_seed(0),
                              device=dev)
            ref_state = adamw_init(ref, opt)
            plain = make_train_step(cfg, opt=opt, device=dev)
            ref, ref_state, ref_losses, ref_ms = timed_steps(plain, ref,
                                                             ref_state)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            sh = distribute(init_params(
                cfg, torch.Generator(dev).manual_seed(0), device=dev), mesh)
            sh_state = adamw_init(sh, opt)
            step = make_train_step(cfg, mesh, opt=opt)(data.batch_at(0))
            sh, sh_state, sh_losses, sh_ms = timed_steps(step, sh, sh_state)
            torch.cuda.synchronize()
            row["peak_bytes"] = torch.cuda.max_memory_allocated()
            pr, ps = param_dict(ref), param_dict(sh)
            bad = [n for n in pr if not (
                same(ps[n].full_tensor(), pr[n])
                and same(sh_state.m[n].full_tensor(), ref_state.m[n])
                and same(sh_state.v[n].full_tensor(), ref_state.v[n]))]
            if bad or not all(same(a, b) for a, b in zip(sh_losses,
                                                          ref_losses)):
                raise AssertionError(
                    f"sharded steps on (1, 1): losses "
                    f"{[float(v) for v in sh_losses]} vs "
                    f"{[float(v) for v in ref_losses]}; {len(bad)} of "
                    f"{len(pr)} parameters (or moments) differ: {bad[:4]}")
            row.update(losses=[float(v) for v in sh_losses],
                       sharded_ms=sh_ms, unsharded_ms=ref_ms,
                       sharded_ms_per_step=sh_ms[-1],
                       unsharded_ms_per_step=ref_ms[-1])
            log(f"  {MESH_STEPS} sharded steps on the (1, 1) mesh ≡ {MESH_STEPS}"
                f" unsharded steps bit for bit: losses "
                f"{[round(v, 6) for v in row['losses']]}, all {len(pr)} "
                f"parameters and both moments; ms/step sharded "
                f"{[round(v, 1) for v in sh_ms]} against unsharded "
                f"{[round(v, 1) for v in ref_ms]} (the first step of each "
                f"pays its set-up); peak {_gib(row['peak_bytes'])} with both "
                f"models resident")

            batch = data.batch_at(MESH_STEPS)
            for name, fn, p, st in (("sharded", step, sh, sh_state),
                                    ("unsharded", plain, ref, ref_state)):
                _, wall, ev = device_profile(
                    lambda: fn(p, st, batch, MESH_STEPS))
                busy = sum(t for _, t, _ in ev)
                steady = row[f"{name}_ms_per_step"]
                row[name] = dict(busy_ms=busy, profiled_ms=wall * 1e3,
                                 kernels=sum(c for _, _, c in ev),
                                 busy_share=busy / steady)
                log(f"  one profiled {name} step: {row[name]['kernels']} "
                    f"kernels, device busy {busy:.1f} ms = "
                    f"{busy / steady:.1%} of its {steady:.1f} ms step "
                    f"({busy / (wall * 1e3):.1%} of {wall * 1e3:.1f} ms "
                    "profiled)")
                for key, t, c in sorted(ev, key=lambda e: -e[1])[:4]:
                    log(f"      {t:9.2f} ms {c:6d}x  {key[:80]}")

            # checkpoints: sharded save, unsharded and elastic restore
            tree = {"params": param_dict(sh), "opt": sh_state}
            whole = {"params": {n: t.full_tensor()
                                for n, t in param_dict(sh).items()},
                     "opt": type(sh_state)(
                         step=sh_state.step,
                         m={n: t.full_tensor() for n, t in sh_state.m.items()},
                         v={n: t.full_tensor() for n, t in sh_state.v.items()})}
            t0 = time.perf_counter()
            ckpt.save(os.path.join(tmp, "sharded"), 1, tree)
            save_s = time.perf_counter() - t0
            ckpt.save(os.path.join(tmp, "plain"), 1, whole)
            digests = [_json.load(open(os.path.join(
                tmp, d, "step_000000001", "manifest.json")))["sha256"]
                for d in ("sharded", "plain")]
            got, _ = ckpt.restore(os.path.join(tmp, "sharded"), whole)
            flat = lambda t: {**t["params"], **{f"m/{n}": v for n, v in  # noqa: E731
                                                 t["opt"].m.items()},
                              **{f"v/{n}": v for n, v in t["opt"].v.items()}}
            ok_plain = all(same(got_t, want) for got_t, want in
                           zip(flat(got).values(), flat(whole).values()))
            ckpt.save(os.path.join(tmp, "params"), 1, param_dict(sh))
            t0 = time.perf_counter()
            el, _ = elastic_restore(os.path.join(tmp, "params"),
                                    param_dict(sh), mesh)
            elastic_s = time.perf_counter() - t0
            ok_el = all(same(el[n].full_tensor(), whole["params"][n])
                        and el[n].placements == ps[n].placements
                        for n in whole["params"])
            if not (ok_plain and ok_el and digests[0] == digests[1]):
                raise AssertionError(
                    f"checkpoint: unsharded restore {ok_plain}, elastic "
                    f"{ok_el}, payload sha256 {digests}")
            row.update(ckpt_save_s=save_s, elastic_restore_s=elastic_s)
            log(f"  sharded checkpoint (saved in {save_s:.1f} s, payload "
                f"sha256 = an unsharded save's) restored unsharded and "
                f"through elastic_restore onto the (1, 1) mesh "
                f"({elastic_s:.1f} s): bit for bit")
            del ref, sh, ref_state, sh_state, tree, whole, got, el
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"  {card}")
    return row


# ------------------------------------------------------------- phase 11
#: the MoE, SSM and hybrid families at full width: parameters (the
#: reference's ``init_params``, by ``jax.eval_shape``)
FAMILIES = {"granite-moe-1b-a400m": 1_334_628_352,
            "mamba2-780m": 780_148_992,
            "zamba2-1.2b": 1_104_937_856}
FAMILY_PROMPTS, FAMILY_NEW = 10, 16        # 10 requests of 8-64 tokens
FAMILY_TRAIN_STEPS = 3
#: the prompt of the stale-slot and fp32 checks: the first request's first
#: 16 tokens (each token is a decode step of the whole model)
FAMILY_SHORT = 16
#: flash_attention composed into one attention layer of each family that
#: has one: (arch, the layer: "layers.0" or "shared"), B = 2, S = 4,096
FAMILY_COMPOSE = (("granite-moe-1b-a400m", "layers.0"),
                  ("zamba2-1.2b", "shared"))
#: llama4-scout at full width, its depth cut to 2 of 48 layers (5.2 B
#: fp32 parameters; 48 would be 100.7 B, more than one card holds)
LLAMA4, LLAMA4_LAYERS, LLAMA4_SEQ, LLAMA4_TICKS = \
    "llama4-scout-17b-a16e", 2, 4096, 4


def _slot_copy(cache, slot):
    """A batch-1 copy of request ``slot``'s cache (every tensor field of
    every stack, batch on axis 1)."""
    import dataclasses
    import torch
    return {n: dataclasses.replace(c, **{
        f.name: getattr(c, f.name).narrow(1, slot, 1).clone()
        for f in dataclasses.fields(c)
        if isinstance(getattr(c, f.name), torch.Tensor)})
        for n, c in cache.items()}


def _family_compose(arch, params, cfg, where, dev):
    """``flash_attention`` composed into ``where``'s attention (dense →
    RoPE → kv heads repeated → kernel → ``wo``) against the model's
    ``attention()`` at fp32 (2e-4) and bf16 (3e-2): max |Δ| by dtype."""
    import dataclasses
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import dtype_of
    lp = params.shared if where == "shared" else params.layers[0]
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, cfg.vocab, (COMPOSE_BATCH, COMPOSE_SEQ),
                           generator=gen).to(dev)
    errs = {}
    for dt, tol in (("float32", 2e-4), ("bfloat16", 3e-2)):
        c = dataclasses.replace(cfg, dtype=dt)
        x = L.rmsnorm(lp.ln1, L.embed(params.embed, tokens, dtype_of(dt)),
                      cfg.norm_eps)
        want = A.attention(lp.attn, x, n_heads=c.n_heads,
                           n_kv_heads=c.n_kv_heads, head_dim=c.hd,
                           rope_theta=c.rope_theta)
        got = _compose(lp, x, c, None)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"{arch} {where} {dt}: flash composition "
                                 f"differs from attention() (max |Δ| {err}, "
                                 f"tolerance {tol})")
        errs[dt] = err
        log(f"  {arch} {where} attention ({cfg.n_heads}:{cfg.n_kv_heads} "
            f"heads, D={cfg.hd}) {dt}: dense → RoPE → flash_attention → wo "
            f"≡ attention() within {tol} (max |Δ| {err:.3e}; |y| max "
            f"{float(want.abs().max()):.3e})")
        del x, want, got
    return errs


def phase_families_flash(dev) -> dict:
    """The kernel alone at the shapes phase 11 composed it into (causal,
    B = 2 × the heads, S = 4,096, D = 64), bf16 and fp32: held against its
    plain version as phase 7 holds it, on the route ``_route`` picks
    (``wgmma``, ``tf32x3``; the other kernel of the dtype held too), both
    timed beside the plain version, SDPA, the bounds and the exponential
    floor (:func:`_flash_alone`).  Outside the path's launch count; rows
    by arch (bf16) and ``<arch>/fp32``."""
    import torch
    from repro_torch.configs import get_config
    rows = {}
    for arch, _ in FAMILY_COMPOSE:
        cfg = get_config(arch)
        bh = COMPOSE_BATCH * cfg.n_heads
        for dt, name in (("bf16", arch), ("fp32", f"{arch}/fp32")):
            q, k, v = _qkv(bh, COMPOSE_SEQ, COMPOSE_SEQ, cfg.hd,
                           torch.bfloat16 if dt == "bf16" else torch.float32,
                           1, dev, 95)
            rows[name] = _flash_alone(
                f"{arch} {dt}", f"BH={bh} S=T={COMPOSE_SEQ} D={cfg.hd} {dt} "
                "causal", q, k, v, dict(causal=True, window=None), 2e-5)
            del q, k, v
            torch.cuda.empty_cache()
    return rows


def _family_serve(arch, params, cfg, dev):
    """``DecodeEngine``, bf16: 10 greedy requests of 8-64 tokens on 8 slots
    (two reused), 16 new tokens each, timed and one window of ticks
    profiled; for an SSM, a reused slot's prefill from its stale state
    against a fresh slot's.  Then at fp32 (a MoE with capacity_factor E/K,
    so no pick is dropped in either grouping): a fresh slot's greedy
    continuation equals the teacher-forced rollout of ``forward_logits``."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import forward_logits
    from repro_torch.models import init_cache
    from repro_torch.serve import DecodeEngine, EngineConfig, bytes_per_slot
    from repro_torch.serve.kv_cache import cache_bytes

    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, int(n))]
               for n in rng.integers(8, 65, FAMILY_PROMPTS)]
    ecfg = EngineConfig(device=str(dev))
    eng = DecodeEngine(cfg, params, ecfg)
    outs, t = _drive(eng, prompts, FAMILY_NEW)
    if sorted(outs) != list(range(len(prompts))) or any(
            len(o) != FAMILY_NEW for o in outs.values()):
        raise AssertionError(f"{arch} engine: outputs "
                             f"{[len(o) for o in outs.values()]}")
    n_prompt = sum(len(p) for p in prompts)
    row = dict(requests=len(prompts), prompt_tokens=n_prompt,
               prefill_ms_per_token=t["prefill_s"] / n_prompt * 1e3,
               ms_per_tick=t["tick_s"] / t["ticks"] * 1e3, ticks=t["ticks"],
               decode_tokens_per_s=sum(len(o) - 1 for o in outs.values())
               / t["tick_s"],
               tokens_per_s=sum(map(len, outs.values()))
               / (t["prefill_s"] + t["tick_s"]),
               cache_bytes_per_slot=bytes_per_slot(cfg, ecfg.max_len))
    if cfg.ssm is not None:
        # slot 0 served two requests and ticked frozen since: its state is
        # stale; the reference prefills a reused slot from it too
        prompt = torch.tensor(prompts[0][:FAMILY_SHORT], device=dev)
        stale = eng._prefill(_slot_copy(eng.cache, 0), prompt)[2]
        fresh = eng._prefill(init_cache(cfg, 1, ecfg.max_len,
                                        torch.bfloat16, device=dev),
                             prompt)[2]
        gap = float((stale - fresh).abs().max())
        if not gap > 0:
            raise AssertionError(f"{arch}: a reused slot's prefill equals a "
                                 "fresh slot's; the reference's keeps the "
                                 "stale state")
        ssm_bytes = [cache_bytes({"ssm": init_cache(
            cfg, 1, m, torch.bfloat16, device="meta")["ssm"]})
            for m in (ecfg.max_len, 8 * ecfg.max_len)]
        if ssm_bytes[0] != ssm_bytes[1]:
            raise AssertionError(f"{arch}: SSM cache bytes {ssm_bytes} "
                                 "depend on max_len")
        row.update(stale_slot_logit_gap=gap, ssm_bytes_per_slot=ssm_bytes[0])
        log(f"  reused slot 0: prefill logits from its stale SSM state differ "
            f"from a fresh slot's by up to {gap:.3f} (as the reference's); "
            f"SSM cache {ssm_bytes[0]} B/slot at max_len {ecfg.max_len} and "
            f"{8 * ecfg.max_len}")
    for p in prompts[:ecfg.batch_slots]:
        eng.add_request(p[:8], max_new=FAMILY_NEW)
    n_prof = 8
    _, wall, ev = device_profile(lambda: [eng.step() for _ in range(n_prof)])
    busy = sum(ms for _, ms, _ in ev) / n_prof
    prof_tick = wall / n_prof * 1e3
    row.update(busy_ms_per_tick=busy, busy_share=busy / prof_tick,
               profiled_ms_per_tick=prof_tick,
               kernels_per_tick=sum(c for _, _, c in ev) / n_prof)
    log(f"  bf16 engine: {len(prompts)} requests ({n_prompt} prompt tokens), "
        f"{t['ticks']} ticks of {ecfg.batch_slots} slots: prefill "
        f"{row['prefill_ms_per_token']:.2f} ms/token, "
        f"{row['ms_per_tick']:.2f} ms/tick = "
        f"{row['decode_tokens_per_s']:.0f} decode tokens/s "
        f"({row['tokens_per_s']:.0f} tokens/s with prefill); {n_prof} "
        f"profiled ticks: device busy {busy:.2f} of {prof_tick:.2f} ms/tick "
        f"= {busy / prof_tick:.1%}, {row['kernels_per_tick']:.0f} "
        f"kernels/tick; cache {row['cache_bytes_per_slot']} B/slot "
        f"[{time.perf_counter() - _START:.0f} s]")
    for key, ms, c in sorted(ev, key=lambda e: -e[1])[:4]:
        log(f"      {ms:9.2f} ms {c:6d}x  {key[:80]}")
    del eng

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    if cfg.moe is not None:
        cfg32 = dataclasses.replace(cfg32, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    eng32 = DecodeEngine(cfg32, params, EngineConfig(
        batch_slots=2, cache_dtype="float32", device=str(dev)))
    outs32, _ = _drive(eng32, [prompts[0][:FAMILY_SHORT]], FP32_CONTINUATION)
    seq, want = list(prompts[0][:FAMILY_SHORT]), []
    for _ in range(FP32_CONTINUATION):
        lg = forward_logits(params, cfg32, {"tokens": torch.tensor(
            [seq], device=dev)}, last_only=True)
        want.append(int(torch.argmax(lg[0, -1])))
        seq.append(want[-1])
    if outs32[0] != want:
        raise AssertionError(f"{arch} fp32 engine {outs32[0]} != rollout "
                             f"{want}")
    cap = ", capacity_factor E/K" if cfg.moe else ""
    log(f"  fp32 engine (fresh slot{cap}): {FP32_CONTINUATION}-token greedy "
        f"continuation of a {FAMILY_SHORT}-token prompt == teacher-forced "
        f"rollout [{time.perf_counter() - _START:.0f} s]")
    return row


class _OneBatch:
    """A ``Trainer``'s data that serves one batch of ``data`` at every
    step."""

    def __init__(self, data):
        self.data = data
        self.batch = data.batch_at(0)

    def batch_at(self, step):
        return self.batch

    def cursor(self, step):
        return self.data.cursor(0)


def _family_train(arch, cfg, dev, seed):
    """A ``Trainer`` with AdamW (bf16 moments, lr 3e-3 from step 0), 3
    steps on one batch of B = 8, S = 128, from fresh parameters: finite
    losses that fall or stay within 1 % after step 0; the gradients finite
    (for the SSMs at chunk 128, where the reference's backward gives NaN);
    ms/step, tokens/s, peak memory and the busy share of one profiled
    step."""
    import math
    import tempfile
    import torch
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                                   Trainer, TrainerConfig, adamw_init,
                                   make_train_step)
    from repro_torch.train.loop import loss_and_grads

    data = _OneBatch(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0), device=dev))
    opt = AdamWConfig(lr=3e-3)                        # launcher's default
    # the launcher's lr from step 0, on one batch: the default schedule's
    # warmup (lr 0, 3e-5, 6e-5) moves the loss less than one batch differs
    # from the next, and the check is that the steps train
    step_fn = make_train_step(cfg, opt=opt, schedule=lambda step: torch.tensor(
        opt.lr), device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(dev).manual_seed(seed),
                         device=dev)
    row = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    if cfg.ssm is not None:
        chunk = min(cfg.ssm.chunk, TRAIN_SEQ)
        _, g = loss_and_grads(params, cfg, data.batch_at(FAMILY_TRAIN_STEPS))
        bad = [n for n, t in g.items() if not bool(torch.isfinite(t).all())]
        del g
        if chunk != 128 or bad:
            raise AssertionError(f"{arch}: chunk {chunk}, non-finite "
                                 f"gradients {bad[:4]}")
        row["chunk"] = chunk
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, data, step_fn, params, adamw_init(params, opt),
                     TrainerConfig(total_steps=FAMILY_TRAIN_STEPS,
                                   ckpt_every=0, ckpt_dir=tmp, log_every=0),
                     torch.Generator().manual_seed(seed))
        tr.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in tr.metrics_log]
    step_ms = [m["step_time_s"] * 1e3 for m in tr.metrics_log]
    if not all(math.isfinite(v) for v in losses) or any(
            v > losses[0] * 1.01 for v in losses[1:]):
        raise AssertionError(f"{arch} AdamW losses {losses}")
    ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    batch = data.batch_at(FAMILY_TRAIN_STEPS)
    _, wall, ev = device_profile(lambda: step_fn(
        tr.params, tr.opt_state, batch, FAMILY_TRAIN_STEPS))
    busy = sum(t for _, t, _ in ev)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    row.update(losses=losses, step_ms=step_ms, ms_per_step=ms,
               tokens_per_s=tokens / ms * 1e3, peak_bytes=peak,
               busy_ms=busy, busy_share=busy / ms,
               busy_share_profiled=busy / (wall * 1e3),
               kernels=sum(c for _, _, c in ev))
    log(f"  AdamW {FAMILY_TRAIN_STEPS} steps B={TRAIN_BATCH} S={TRAIN_SEQ}"
        f"{' (SSD chunk 128: gradients finite)' if cfg.ssm else ''}: losses "
        f"{[round(v, 4) for v in losses]}; steps "
        f"{[round(v, 1) for v in step_ms]} ms → {ms:.1f} ms/step = "
        f"{tokens / ms * 1e3:.0f} tokens/s; peak {_gib(peak)}; one profiled "
        f"step: device busy {busy:.1f} ms = {busy / ms:.1%}, "
        f"{row['kernels']} kernels [{time.perf_counter() - _START:.0f} s]")
    row["cell"] = _cell(arch, f"train B{TRAIN_BATCH}xS{TRAIN_SEQ}", "train",
                        cfg.active_param_count(), TRAIN_BATCH, TRAIN_SEQ,
                        lambda: step_fn(tr.params, tr.opt_state, batch,
                                        FAMILY_TRAIN_STEPS), ms)
    del tr, params
    torch.cuda.empty_cache()
    return row


def phase_families(dev, card):
    """The MoE, SSM and hybrid families at full width (random fp32
    parameters drawn on the card from a seeded generator, bf16 compute):
    for each, ``forward_logits(last_only)`` at B = 1, S = 8,192 timed, the
    ``DecodeEngine`` checks of :func:`_family_serve`, ``flash_attention``
    composed into its attention layer where it has one, and 3 AdamW steps;
    then llama4-scout at full width and 2 layers: the forward at S = 4,096
    and 4 decode ticks."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, forward_logits, init_params
    from repro_torch.serve import DecodeEngine, EngineConfig

    compose = dict(FAMILY_COMPOSE)
    rows = {"card": card}
    for i, (arch, n_want) in enumerate(FAMILIES.items()):
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        params = init_params(cfg, torch.Generator(dev).manual_seed(20 + i),
                             device=dev)
        n = count_params(params)
        if n != n_want:
            raise AssertionError(f"{arch}: {n} parameters, the reference's "
                                 f"init_params {n_want}")
        gen = torch.Generator().manual_seed(13)
        tokens = torch.randint(0, cfg.vocab, (1, LM_SEQ),
                               generator=gen).to(dev)
        def fwd():
            return forward_logits(params, cfg, {"tokens": tokens},
                                  last_only=True)
        torch.cuda.reset_peak_memory_stats()
        logits = fwd()
        torch.cuda.synchronize()
        if logits.shape != (1, 1, cfg.vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{arch} forward_logits: shape "
                                 f"{tuple(logits.shape)}, finite "
                                 f"{bool(torch.isfinite(logits).all())}")
        walls = [_single(fwd)[1] for _ in range(3)]
        row = dict(params=n, forward_ms=min(walls) * 1e3,
                   forward_tokens_per_s=LM_SEQ / min(walls),
                   forward_peak_bytes=torch.cuda.max_memory_allocated())
        if cfg.moe is not None:
            row["group_capacity"] = math.ceil(
                1024 * cfg.moe.top_k * cfg.moe.capacity_factor
                / cfg.moe.n_experts)
        log(f"[{arch}, {time.perf_counter() - _START:.0f} s] {n} "
            f"parameters; forward_logits(last_only) B=1 "
            f"S={LM_SEQ} {cfg.dtype}: {row['forward_ms']:.1f} ms (of "
            f"{[round(w * 1e3, 1) for w in walls]}) = "
            f"{row['forward_tokens_per_s']:.0f} tokens/s; peak "
            f"{_gib(row['forward_peak_bytes'])}")
        row["cell"] = _cell(arch, f"prefill B1xS{LM_SEQ}", "prefill",
                            cfg.active_param_count(), 1, LM_SEQ, fwd,
                            row["forward_ms"])
        del logits
        if arch in compose:
            row["compose_err"] = _family_compose(arch, params, cfg,
                                                 compose[arch], dev)
        row["engine"] = _family_serve(arch, params, cfg, dev)
        del params
        row["train"] = _family_train(arch, cfg, dev, 30 + i)
        rows[arch] = row

    cfg = dataclasses.replace(get_config(LLAMA4), n_layers=LLAMA4_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(dev).manual_seed(40),
                         device=dev)
    n = count_params(params)
    gen = torch.Generator().manual_seed(14)
    tokens = torch.randint(0, cfg.vocab, (1, LLAMA4_SEQ),
                           generator=gen).to(dev)
    def fwd():
        return forward_logits(params, cfg, {"tokens": tokens},
                              last_only=True)
    logits = fwd()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{LLAMA4}: forward_logits not finite")
    walls = [_single(fwd)[1] for _ in range(2)]
    del logits
    eng = DecodeEngine(cfg, params, EngineConfig(batch_slots=2, max_len=64,
                                                 device=str(dev)))
    for _ in range(2):
        eng.add_request([int(t) for t in torch.randint(
            1, cfg.vocab, (8,), generator=gen)], max_new=LLAMA4_TICKS + 1)
    _, tick_s = _single(lambda: [eng.step() for _ in range(LLAMA4_TICKS)])
    if any(len(o) != LLAMA4_TICKS + 1 for o in eng.outputs):
        raise AssertionError(f"{LLAMA4} engine: {eng.outputs}")
    rows[LLAMA4] = dict(
        layers=LLAMA4_LAYERS, params=n, forward_ms=min(walls) * 1e3,
        forward_tokens_per_s=LLAMA4_SEQ / min(walls),
        ms_per_tick=tick_s / LLAMA4_TICKS * 1e3,
        peak_bytes=torch.cuda.max_memory_allocated(),
        group_capacity=math.ceil(1024 * cfg.moe.top_k
                                 * cfg.moe.capacity_factor
                                 / cfg.moe.n_experts))
    log(f"[{LLAMA4}, {time.perf_counter() - _START:.0f} s] "
        f"{LLAMA4_LAYERS} of 48 layers at full width, {n} "
        f"parameters; forward_logits(last_only) B=1 S={LLAMA4_SEQ}: "
        f"{min(walls) * 1e3:.1f} ms; {LLAMA4_TICKS} decode ticks of 2 slots "
        f"{tick_s / LLAMA4_TICKS * 1e3:.1f} ms each (top-1 of 16 experts, "
        f"cap {rows[LLAMA4]['group_capacity']} a 1,024-token group); peak "
        f"{_gib(rows[LLAMA4]['peak_bytes'])}")
    del eng, params
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------- phase 12
#: whisper-base at full width: parameters (the reference's ``init_params``,
#: by ``jax.eval_shape``); its encoder's 1,500 frames
WHISPER, WHISPER_PARAMS, N_FRAMES = "whisper-base", 70_686_208, 1500
#: forward_logits(last_only): train_4k's length at one card's batch, and
#: prefill_32k's per-sequence length (the Q-chunked path)
WHISPER_PREFILL = ((8, 4096), (1, 32768))
#: training: B 8 at whisper's decoder context
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 8, 448
#: flash_attention composed into encoder layer 0 (S = T = 1,500) and
#: decoder layer 0's cross attention (S 4,096, T 1,500), at B 8
WHISPER_COMPOSE_BATCH, WHISPER_COMPOSE_SEQ = 8, 4096
#: the int8 KV cache at gemma3-1b's global-layer shape (d 1,152, H 4,
#: Hk 1, hd 256), B 8, a 32,768-position cache; the reference test's bound
QUANT_SHAPE = dict(d=1152, h=4, hk=1, hd=256, b=8, t=32768)
QUANT_REL_MAX, QUANT_BYTES_MAX = 0.05, 0.6


def _whisper_audio(cfg, n, dev, seed):
    """``n`` requests' frame embeddings [n_ctx, d_model], each from its own
    seeded generator on the card."""
    import torch
    return [torch.randn((cfg.encoder.n_ctx, cfg.d_model), device=dev,
                        generator=torch.Generator(dev).manual_seed(seed + i))
            for i in range(n)]


def _flash_cross(attn, x, kv_src, cfg):
    """``attention(cross_kv=)`` rebuilt around the kernel: dense (no RoPE)
    → kv heads repeated → head-major ``flash_attention`` (non-causal; one
    block of S queries and one of T keys, which divide S and T: the
    kernel tiles and masks its own ragged edges) → ``wo``."""
    from repro_torch.kernels import flash_attention
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    b, s, _ = x.shape
    t = kv_src.shape[1]
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = A._split_heads(L.dense(attn.wq, x), h, hd)
    k = A._repeat_kv(A._split_heads(L.dense(attn.wk, kv_src), hk, hd), h)
    v = A._repeat_kv(A._split_heads(L.dense(attn.wv, kv_src), hk, hd), h)
    qh = q.permute(0, 2, 1, 3).reshape(b * h, s, hd).contiguous()
    kh, vh = (u.permute(0, 2, 1, 3).reshape(b * h, t, hd).contiguous()
              for u in (k, v))
    o = flash_attention(qh, kh, vh, causal=False, window=None, block_q=s,
                        block_k=t)
    o = o.reshape(b, h, s, hd).permute(0, 2, 1, 3).reshape(b, s, h * hd)
    return L.dense(attn.wo, o)


def _whisper_compose(params, cfg, dev) -> dict:
    """``flash_attention`` composed into encoder layer 0 (non-causal,
    S = T = 1,500: 1,500 = 23 · 64 + 28, a ragged last key tile) and into decoder layer 0's cross attention (S 4,096, T 1,500)
    against ``attention()`` at fp32 (2e-4) and bf16 (3e-2); these launches
    count on the path."""
    import dataclasses
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import encdec
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import dtype_of
    b, s = WHISPER_COMPOSE_BATCH, WHISPER_COMPOSE_SEQ
    audio = torch.stack(_whisper_audio(cfg, b, dev, 300))
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator(
        ).manual_seed(15)).to(dev)
    errs = {}
    for dt, tol in (("float32", 2e-4), ("bfloat16", 3e-2)):
        c = dataclasses.replace(cfg, dtype=dt)
        kw = dict(n_heads=c.n_heads, n_kv_heads=c.n_kv_heads, head_dim=c.hd)
        x = audio.to(dtype_of(dt)) + encdec._sinusoids(
            audio.shape[1], c.d_model, dev).to(dtype_of(dt))[None]
        lp = params.enc_layers[0]
        u = L.norm(lp.ln1, x, c.norm_eps)
        enc = encdec.encode(params, c, audio)
        dp = params.dec_layers[0]
        y = L.norm(dp.lnx, L.embed(params.embed, tokens, dtype_of(dt)),
                   c.norm_eps)
        for where, attn, q_in, kv in (
                ("encoder layer 0", lp.attn, u, u),
                ("decoder layer 0 cross", dp.xattn, y, enc)):
            want = A.attention(attn, q_in, cross_kv=kv, **kw)
            got = _flash_cross(attn, q_in, kv, c)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
                raise AssertionError(f"{WHISPER} {where} {dt}: flash "
                                     f"composition differs from attention() "
                                     f"(max |Δ| {err}, tolerance {tol})")
            errs[f"{where}/{dt}"] = err
            log(f"  {where} (S={q_in.shape[1]} T={kv.shape[1]} B={b}, "
                f"{c.n_heads} heads, D={c.hd}) {dt}: dense → "
                f"flash_attention(non-causal) → wo ≡ attention(cross_kv=) "
                f"within {tol} (max |Δ| {err:.3e}; |y| max "
                f"{float(want.abs().max()):.3e})")
            del want, got
        del x, u, enc, y
        torch.cuda.empty_cache()
    return errs


def phase_whisper_flash(dev) -> dict:
    """The kernel alone at the shapes phase 12 composed it into
    (non-causal, BH 64, D 64; S = T = 1,500 and S 4,096 × T 1,500), bf16
    and fp32: held against its plain version as phase 7 holds it, on the
    route ``_route`` picks (``wgmma``, ``tf32x3``; the other kernel of the
    dtype held too), both timed beside the plain version, SDPA, the bounds
    (S·T live pairs) and the exponential floor (:func:`_flash_alone`).
    Outside the path's launch count; rows ``encoder``, ``cross`` (bf16)
    and ``<label>/fp32``."""
    import torch
    bh = WHISPER_COMPOSE_BATCH * 8
    rows = {}
    for label, s in (("encoder", N_FRAMES), ("cross", WHISPER_COMPOSE_SEQ)):
        for dt, name in (("bf16", label), ("fp32", f"{label}/fp32")):
            q, k, v = _qkv(bh, s, N_FRAMES, 64,
                           torch.bfloat16 if dt == "bf16" else torch.float32,
                           1, dev, 96)
            rows[name] = _flash_alone(
                f"{WHISPER} {label} {dt}", f"BH={bh} S={s} T={N_FRAMES} D=64 "
                f"{dt} non-causal", q, k, v,
                dict(causal=False, window=None, block_q=s, block_k=N_FRAMES),
                2e-5)
            del q, k, v
            torch.cuda.empty_cache()
    return rows


def _whisper_serve(params, cfg, dev) -> dict:
    """``DecodeEngine`` (bf16, 8 slots, max_len 1,024): 10 greedy requests
    of 8-64 tokens, each with its own audio, 16 new tokens each (two slots
    reused), timed, and 8 profiled ticks of a full engine; then at fp32 a
    fresh slot's greedy continuation of a 16-token prompt equals the
    teacher-forced rollout of ``forward_logits`` with the same audio."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import forward_logits
    from repro_torch.serve import DecodeEngine, EngineConfig, bytes_per_slot
    from repro_torch.serve.kv_cache import cache_bytes

    rng = np.random.default_rng(16)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, int(n))]
               for n in rng.integers(8, 65, FAMILY_PROMPTS)]
    audio = _whisper_audio(cfg, len(prompts), dev, 200)
    ecfg = EngineConfig(device=str(dev))
    eng = DecodeEngine(cfg, params, ecfg)
    outs, t = _drive(eng, prompts, FAMILY_NEW, audio)
    if sorted(outs) != list(range(len(prompts))) or any(
            len(o) != FAMILY_NEW for o in outs.values()):
        raise AssertionError(f"{WHISPER} engine: outputs "
                             f"{[len(o) for o in outs.values()]}")
    n_prompt = sum(len(p) for p in prompts)
    slot = eng.cache
    self_b = cache_bytes({"self": slot["self"]}) // ecfg.batch_slots
    cross_b = cache_bytes({"k": slot["cross_k"], "v": slot["cross_v"]}) \
        // ecfg.batch_slots
    row = dict(requests=len(prompts), prompt_tokens=n_prompt,
               prefill_ms_per_token=t["prefill_s"] / n_prompt * 1e3,
               ms_per_tick=t["tick_s"] / t["ticks"] * 1e3, ticks=t["ticks"],
               decode_tokens_per_s=sum(len(o) - 1 for o in outs.values())
               / t["tick_s"],
               tokens_per_s=sum(map(len, outs.values()))
               / (t["prefill_s"] + t["tick_s"]),
               cache_bytes_per_slot=bytes_per_slot(cfg, ecfg.max_len),
               self_bytes_per_slot=self_b, cross_bytes_per_slot=cross_b)
    if self_b + cross_b != row["cache_bytes_per_slot"]:
        raise AssertionError(f"cache bytes a slot {row}")
    for p, a in zip(prompts[:ecfg.batch_slots], audio):
        eng.add_request(p[:8], max_new=FAMILY_NEW, audio_embeds=a)
    n_prof = 8
    _, wall, ev = device_profile(lambda: [eng.step() for _ in range(n_prof)])
    busy = sum(ms for _, ms, _ in ev) / n_prof
    prof_tick = wall / n_prof * 1e3
    row.update(busy_ms_per_tick=busy, busy_share=busy / prof_tick,
               profiled_ms_per_tick=prof_tick,
               kernels_per_tick=sum(c for _, _, c in ev) / n_prof)
    log(f"  bf16 engine: {len(prompts)} requests ({n_prompt} prompt tokens, "
        f"each with its audio), {t['ticks']} ticks of {ecfg.batch_slots} "
        f"slots: prefill {row['prefill_ms_per_token']:.2f} ms/token "
        f"(encode + prefill_cross included), {row['ms_per_tick']:.2f} "
        f"ms/tick = {row['decode_tokens_per_s']:.0f} decode tokens/s "
        f"({row['tokens_per_s']:.0f} tokens/s with prefill); {n_prof} "
        f"profiled ticks: device busy {busy:.2f} of {prof_tick:.2f} ms/tick "
        f"= {busy / prof_tick:.1%}, {row['kernels_per_tick']:.0f} "
        f"kernels/tick; cache {row['cache_bytes_per_slot']} B/slot (self "
        f"{self_b}, cross {cross_b}) [{time.perf_counter() - _START:.0f} s]")
    for key, ms, c in sorted(ev, key=lambda e: -e[1])[:4]:
        log(f"      {ms:9.2f} ms {c:6d}x  {key[:80]}")
    del eng

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    eng32 = DecodeEngine(cfg32, params, EngineConfig(
        batch_slots=2, cache_dtype="float32", device=str(dev)))
    prompt = prompts[0][:FAMILY_SHORT]
    outs32, _ = _drive(eng32, [prompt], FP32_CONTINUATION, audio[:1])
    seq, want = list(prompt), []
    for _ in range(FP32_CONTINUATION):
        lg = forward_logits(params, cfg32, {
            "tokens": torch.tensor([seq], device=dev),
            "audio_embeds": audio[0][None]}, last_only=True)
        want.append(int(torch.argmax(lg[0, -1])))
        seq.append(want[-1])
    if outs32[0] != want:
        raise AssertionError(f"{WHISPER} fp32 engine {outs32[0]} != rollout "
                             f"{want}")
    log(f"  fp32 engine (fresh slot): {FP32_CONTINUATION}-token greedy "
        f"continuation of a {FAMILY_SHORT}-token prompt with its audio == "
        f"teacher-forced rollout [{time.perf_counter() - _START:.0f} s]")
    return row


def _whisper_train(cfg, dev) -> dict:
    """A ``Trainer`` with AdamW (bf16 moments, lr 3e-3 from step 0), 3 steps
    on one batch of B 8, S 448 with audio: finite losses that fall or stay
    within 1 % of step 0's; ms/step, tokens/s, peak memory, the busy share
    of one profiled step.  Then 2 CGGN steps through
    ``launch/train.cggn_lm_step`` on that batch, every metric finite."""
    import math
    import tempfile
    import torch
    from repro_torch.launch.train import CGGN_CONFIG, cggn_lm_step
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                                   Trainer, TrainerConfig, adamw_init,
                                   cggn_init, make_train_step)

    b, s = WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ
    data = _OneBatch(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b, seed=0), device=dev))
    data.batch["audio_embeds"] = torch.stack(_whisper_audio(cfg, b, dev,
                                                            400))
    opt = AdamWConfig(lr=3e-3)
    step_fn = make_train_step(cfg, opt=opt, schedule=lambda step: torch.tensor(
        opt.lr), device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(dev).manual_seed(51),
                         device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, data, step_fn, params, adamw_init(params, opt),
                     TrainerConfig(total_steps=FAMILY_TRAIN_STEPS,
                                   ckpt_every=0, ckpt_dir=tmp, log_every=0),
                     torch.Generator().manual_seed(51))
        tr.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in tr.metrics_log]
    step_ms = [m["step_time_s"] * 1e3 for m in tr.metrics_log]
    if not all(math.isfinite(v) for v in losses) or any(
            v > losses[0] * 1.01 for v in losses[1:]):
        raise AssertionError(f"{WHISPER} AdamW losses {losses}")
    ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    _, wall, ev = device_profile(lambda: step_fn(
        tr.params, tr.opt_state, data.batch, FAMILY_TRAIN_STEPS))
    busy = sum(t for _, t, _ in ev)
    tokens = b * s
    row = dict(batch=b, seq=s, frames=cfg.encoder.n_ctx, losses=losses,
               step_ms=step_ms, ms_per_step=ms,
               tokens_per_s=tokens / ms * 1e3, peak_bytes=peak,
               busy_ms=busy, busy_share=busy / ms,
               busy_share_profiled=busy / (wall * 1e3),
               kernels=sum(c for _, _, c in ev))
    log(f"  AdamW {FAMILY_TRAIN_STEPS} steps B={b} S={s} "
        f"({cfg.encoder.n_ctx} frames a row): losses {[round(v, 4) for v in losses]}; steps "
        f"{[round(v, 1) for v in step_ms]} ms → {ms:.1f} ms/step = "
        f"{tokens / ms * 1e3:.0f} tokens/s; peak {_gib(peak)}; one profiled "
        f"step: device busy {busy:.1f} ms = {busy / ms:.1%}, "
        f"{row['kernels']} kernels [{time.perf_counter() - _START:.0f} s]")
    del tr

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = cggn_init(params, 0)
    steps = []
    for step in range(CGGN_STEPS):
        (params, state, m), wall = _single(
            lambda: cggn_lm_step(params, state, data.batch))
        m = {k: float(v) for k, v in m.items()}
        m["ms"] = wall * 1e3
        steps.append(m)
        if not all(math.isfinite(v) for v in m.values()) or \
                m["delta_norm"] > CGGN_CONFIG.max_delta_norm * (1 + 1e-6):
            raise AssertionError(f"{WHISPER} CGGN step {step}: {m}")
    row.update(cggn_steps=steps,
               cggn_peak_bytes=torch.cuda.max_memory_allocated())
    log(f"  CGGN {CGGN_STEPS} steps (cggn_lm_step, audio fed): losses "
        f"{[round(m['loss'], 4) for m in steps]}, |δ| "
        f"{[round(m['delta_norm'], 4) for m in steps]}, inner CG "
        f"{[int(m['cg_iters']) for m in steps]} iterations, "
        f"{[round(m['ms']) for m in steps]} ms; peak "
        f"{_gib(row['cggn_peak_bytes'])} [{time.perf_counter() - _START:.0f}"
        f" s]")
    del params, state
    torch.cuda.empty_cache()
    return row


def phase_quant_cache(dev) -> dict:
    """The int8 KV cache at gemma3-1b's global-layer shape: both caches
    hold the same 32,767 random positions (bf16, and their int8
    quantization), then one decode step at the last position:
    ``attn_decode_quant`` against ``attn_decode`` at bf16 within max
    |Δ| / max |y| < 0.05, cache bytes under 0.6× bf16's, ms a decode call
    of each."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models.layers import draw_parameters
    from repro_torch.serve import (attn_decode_quant, init_quant_cache,
                                   quantize_kv)
    from repro_torch.serve.kv_cache import cache_bytes
    q = QUANT_SHAPE
    gen = torch.Generator(dev).manual_seed(17)
    p = draw_parameters(A.Attention(q["d"], q["h"], q["hk"], q["hd"],
                                    device=dev), gen)
    bf = A.init_attn_cache(q["b"], q["t"], q["hk"], q["hd"],
                           dtype=torch.bfloat16, device=dev)
    qc = init_quant_cache(q["b"], q["t"], q["hk"], q["hd"], device=dev)
    for name in ("k", "v"):
        rows = torch.randn(bf.k.shape, generator=gen, device=dev).to(
            torch.bfloat16)
        getattr(bf, name).copy_(rows)
        vals, scale = quantize_kv(rows)
        getattr(qc, name).copy_(vals)
        getattr(qc, f"{name}_scale").copy_(scale)
        del rows, vals, scale
    x = torch.randn((q["b"], 1, q["d"]), generator=gen, device=dev).to(
        torch.bfloat16)
    pos = q["t"] - 1
    kw = dict(n_heads=q["h"], n_kv_heads=q["hk"], head_dim=q["hd"])
    y, _ = A.attn_decode(p, x, bf, pos, **kw)
    yq, _ = attn_decode_quant(p, x, qc, pos, **kw)
    torch.cuda.synchronize()
    rel = float((y.float() - yq.float()).abs().max()
                / (y.float().abs().max() + 1e-6))
    qb, fb = cache_bytes({"q": qc}), cache_bytes({"bf16": bf})
    if not (rel < QUANT_REL_MAX and qb < QUANT_BYTES_MAX * fb and bool(
            torch.isfinite(yq).all())):
        raise AssertionError(f"int8 cache: max |Δ|/max |y| {rel}, bytes "
                             f"{qb} against bf16's {fb}")
    t_bf = cuda_ms(lambda: A.attn_decode(p, x, bf, pos, **kw))
    t_q = cuda_ms(lambda: attn_decode_quant(p, x, qc, pos, **kw))
    row = dict(shape=f"B={q['b']} H={q['h']} Hk={q['hk']} hd={q['hd']} "
               f"T={q['t']} d={q['d']}", rel_err=rel, bytes=qb,
               bf16_bytes=fb, bytes_ratio=qb / fb, ms=t_q, bf16_ms=t_bf)
    log(f"  int8 cache {row['shape']}: attn_decode_quant ≡ attn_decode (bf16) "
        f"within max |Δ|/max |y| {rel:.4f} < {QUANT_REL_MAX}; {qb} B against "
        f"{fb} B = {qb / fb:.3f}× (< {QUANT_BYTES_MAX}); a decode call "
        f"{t_q:.3f} ms (bf16 cache {t_bf:.3f} ms)")
    del bf, qc
    torch.cuda.empty_cache()
    return row


def phase_whisper(dev, card) -> dict:
    """whisper-base at full width (random fp32 parameters drawn on the card
    from a seeded generator, bf16 compute): ``forward_logits(last_only)``
    at B 8, S 4,096 and at B 1, S 32,768 with 1,500 frames, timed; the
    kernel composed into the encoder and the cross attention; the
    ``DecodeEngine`` checks of :func:`_whisper_serve`; AdamW and CGGN
    steps (:func:`_whisper_train`); the int8 KV cache."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, forward_logits, init_params

    cfg = get_config(WHISPER)
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(dev).manual_seed(50),
                         device=dev)
    n = count_params(params)
    if n != WHISPER_PARAMS:
        raise AssertionError(f"{WHISPER}: {n} parameters, the reference's "
                             f"init_params {WHISPER_PARAMS}")
    rows = {"card": card, "params": n, "prefill": {}}
    for b, s in WHISPER_PREFILL:
        tokens = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator(
            ).manual_seed(s)).to(dev)
        audio = torch.stack(_whisper_audio(cfg, b, dev, 100))

        def fwd():
            return forward_logits(params, cfg, {"tokens": tokens,
                                                "audio_embeds": audio},
                                  last_only=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        logits = fwd()
        torch.cuda.synchronize()
        if logits.shape != (b, 1, cfg.vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{WHISPER} forward_logits: shape "
                                 f"{tuple(logits.shape)}, finite "
                                 f"{bool(torch.isfinite(logits).all())}")
        walls = [_single(fwd)[1] for _ in range(3)]
        peak = torch.cuda.max_memory_allocated()
        rows["prefill"][f"B{b}xS{s}"] = dict(
            ms=min(walls) * 1e3, tokens_per_s=b * s / min(walls),
            peak_bytes=peak, walls_ms=[w * 1e3 for w in walls])
        log(f"[{WHISPER}, {time.perf_counter() - _START:.0f} s] {n} "
            f"parameters; forward_logits(last_only) B={b} S={s}, "
            f"{cfg.encoder.n_ctx} frames, {cfg.dtype}: {min(walls) * 1e3:.1f} ms (of "
            f"{[round(w * 1e3, 1) for w in walls]}) = "
            f"{b * s / min(walls):.0f} tokens/s; peak {_gib(peak)}")
        if (b, s) == WHISPER_PREFILL[0]:
            rows["prefill"][f"B{b}xS{s}"]["cell"] = _cell(
                WHISPER, f"prefill B{b}xS{s}", "prefill",
                cfg.active_param_count(), b, s, fwd, min(walls) * 1e3)
        del logits, tokens, audio
    rows["compose_err"] = _whisper_compose(params, cfg, dev)
    rows["engine"] = _whisper_serve(params, cfg, dev)
    del params
    torch.cuda.empty_cache()
    rows["train"] = _whisper_train(cfg, dev)
    rows["quant_cache"] = phase_quant_cache(dev)
    return rows


# ------------------------------------------------------------- phase 13
#: the paper's protocol (Tables 4, 5 and 7) over the 12-matrix Table 3
#: suite: b = 1, x0 = 0, rr < 1e-12, maxiter 20,000, ``vsr`` × ``pallas``;
#: fp64 and mixed_v3 gated on every matrix, Table 7's other columns on the
#: small tier logged and not gated
SUITE_SCHEMES = ("fp64", "mixed_v3")
SUITE_TABLE7 = ("mixed_v2", "mixed_v1")
SUITE_MAXITER = 20_000


def _exit_status(res, maxiter) -> str:
    """A single-system solve's exit in the health layer's names (its
    ``CGResult`` carries none, as the reference's does not): the loop
    stops on convergence, at ``maxiter``, or on a non-finite ‖r‖²."""
    if res.converged:
        return "CONVERGED"
    if not math.isfinite(res.rr):
        return "BREAKDOWN_NONFINITE"
    return "MAXITER" if res.iterations >= maxiter else "STOPPED"


def phase_suite(dev) -> dict:
    """``benchmark_suite("all")`` through ``jpcg_solve(method="vsr",
    backend="pallas")`` at full size: each solve a call from the CSR and
    the loop alone on a pre-built operator (Table 4), ms an iteration and
    GFLOP/s by the paper's count (Table 5), the iterations and their
    differences from fp64 (Table 7), each loop's share of its analytic
    bound (``roofline.solver_terms``) and of the ELLPACK operand's
    stored-slot bound; on the small tier ``pallas`` against ``xla``."""
    import numpy as np
    import torch
    from repro_torch import jpcg_solve
    from repro_torch.core.precision import get_scheme
    from repro_torch.kernels import ops
    from repro_torch.roofline import solver_terms
    from repro_torch.roofline.model import solver_flops_per_iter
    from repro_torch.sparse import (benchmark_suite, csr_to_ellpack,
                                    suite_metadata)

    t0 = time.perf_counter()
    small = benchmark_suite("small")
    suite = {**small, **benchmark_suite("large")}
    meta = suite_metadata()
    log(f"  {len(suite)} matrices ({len(small)} small) generated in "
        f"{time.perf_counter() - t0:.1f} s")
    rows, table7 = [], []
    for name, a in suite.items():
        n, nnz = a.shape[0], a.nnz
        t0 = time.perf_counter()
        m = csr_to_ellpack(a)
        diag = a.diagonal()
        pack_s = time.perf_counter() - t0
        its = {}
        schemes = SUITE_SCHEMES + (SUITE_TABLE7 if name in small else ())
        for scheme in schemes:
            sch = get_scheme(scheme)
            kw = dict(method="vsr", backend="pallas", scheme=scheme,
                      tol=SOLVE_TOL, maxiter=SUITE_MAXITER, device=dev)
            res, call_s = _single(lambda: jpcg_solve(a, **kw))
            k = res.iterations
            res_true = residual(a, res.x)
            if scheme in SUITE_SCHEMES and not (
                    res.converged and res_true <= RESIDUAL_MAX):
                raise AssertionError(
                    f"suite {name} {scheme}: converged {res.converged} "
                    f"after {k}, true residual {res_true:.3e}")
            t0 = time.perf_counter()
            op = ops.ell_operator_pallas(m, scheme, diag=diag, device=dev)
            build_s = time.perf_counter() - t0
            loop, loop_s = _single(lambda: jpcg_solve(op, **kw))
            if loop.iterations != k or not torch.equal(loop.x, res.x):
                raise AssertionError(f"suite {name} {scheme}: loop alone "
                                     f"took {loop.iterations}, the call {k}")
            its[scheme] = k
            ms_it = loop_s / k * 1e3
            terms = solver_terms(a, sch)
            bound_ms = terms.bound_s * 1e3
            stored_ms = solver_terms(a, sch, matrix_bytes=m.stream_bytes(
                value_bytes=sch.matrix_bytes,
                index_bytes=m.local_cols.dtype.itemsize)).bound_s * 1e3
            share = _share(f"suite {name} {scheme}", bound_ms, ms_it)
            stored_share = _share(f"suite {name} {scheme} (stored)",
                                  stored_ms, ms_it)
            row = dict(matrix=name, analogue=meta[name], n=n, nnz=nnz,
                       scheme=scheme, iterations=k, converged=res.converged,
                       status=_exit_status(res, SUITE_MAXITER),
                       true_residual=res_true, call_s=call_s,
                       ellpack_pack_s=pack_s, build_s=build_s,
                       loop_s=loop_s, ms_per_iter=ms_it,
                       gflops=solver_flops_per_iter(n, nnz) * k / loop_s
                       / 1e9,
                       bound_ms_per_iter=bound_ms, bound_share=share,
                       bound_by=terms.dominant,
                       stored_bound_ms_per_iter=stored_ms,
                       stored_share=stored_share,
                       padding_efficiency=m.padding_efficiency)
            if name in small and scheme in SUITE_SCHEMES:
                rx, xla_s = _single(lambda: jpcg_solve(a, **dict(
                    kw, backend="xla")))
                if abs(rx.iterations - k) > 1:
                    raise AssertionError(f"suite {name} {scheme}: pallas {k}"
                                         f" vs xla {rx.iterations}")
                np.testing.assert_allclose(
                    rx.x.cpu().numpy(), res.x.cpu().numpy(), rtol=1e-4,
                    atol=1e-6, err_msg=f"suite {name} {scheme} xla")
                row.update(xla_iterations=rx.iterations, xla_call_s=xla_s)
            rows.append(row)
            log(f"  {name} (n {n}, nnz {nnz}) {scheme}: {k} iterations "
                f"({row['status']}, true "
                f"residual {res_true:.2e}); call {call_s:.3f} s, loop alone "
                f"{loop_s:.4f} s = {ms_it:.4f} ms/iteration = "
                f"{row['gflops']:.2f} GFLOP/s; bound {bound_ms:.5f} ms "
                f"({share:.1%}), stored-slot bound {stored_ms:.5f} ms "
                f"({stored_share:.1%})"
                + (f"; xla {row['xla_iterations']} iterations, x within "
                   "rtol 1e-4" if "xla_iterations" in row else ""))
        t7 = dict(matrix=name, iters_fp64=its["fp64"],
                  iters_v3=its["mixed_v3"],
                  diff_v3=its["mixed_v3"] - its["fp64"])
        for scheme, key in (("mixed_v2", "v2"), ("mixed_v1", "v1")):
            if scheme in its:
                t7.update({f"iters_{key}": its[scheme],
                           f"diff_{key}": its[scheme] - its["fp64"]})
        table7.append(t7)
        del m, diag
    log("  Table 7: " + "; ".join(
        f"{t['matrix']} {t['iters_fp64']}/{t['diff_v3']:+d}" for t in table7))
    return dict(rows=rows, table7=table7)


# ------------------------------------------------------------- phase 14
def _counted(label, fn) -> dict:
    """One call of ``fn`` counted op by op (``roofline.count_torch``),
    outside every timed window."""
    import torch
    from repro_torch.roofline import count_torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = count_torch(fn)
    torch.cuda.synchronize()
    out = dict(flops=w.flops, transcendentals=w.transcendentals,
               hbm_bytes=w.hbm_bytes, wire_bytes=w.wire_bytes,
               collectives=w.collective_count,
               count_s=time.perf_counter() - t0)
    log(f"  counted {label}: {w.flops:.4e} flops, {w.hbm_bytes:.4e} B, "
        f"{w.wire_bytes:.0f} wire B, in {out['count_s']:.1f} s")
    return out


def _cell(arch, shape, kind, n_active, batch, seq, fn, ms) -> dict:
    """An LM cell for phase 14: its measured ms, its counted cost and its
    model flops as the reference's dry run takes them (train 6·N·D,
    prefill 2·N·B·S, decode 2·N·B; N the active parameters)."""
    from repro_torch.roofline import model_flops_decode, model_flops_train
    if kind == "train":
        mf = model_flops_train(n_active, batch * seq)
    elif kind == "prefill":
        mf = 2.0 * n_active * batch * seq
    else:
        mf = model_flops_decode(n_active, batch)
    return dict(arch=arch, shape=shape, kind=kind, active_params=n_active,
                model_flops=mf, ms=ms, cost=_counted(f"{arch} {shape}", fn))


def phase_roofline(cells) -> list:
    """Each LM cell's roofline terms on the H100 at the bf16 peak, beside
    the time its phase measured: bound over measured (≤ 105 %), the
    useful fraction, MFU at the measured time and the counted flops'
    utilisation (counted flops over measured time × peak), which needs
    no model-flops convention.  Where the model flops exceed the counted
    ones (useful > 1: a last-token prefill's unembedding, an
    encoder-decoder's parameters priced per decoder token) the MFU
    overcounts what the card did, and the row says so."""
    from repro_torch.roofline import H100, format_table, roofline_terms
    out = []
    for c in cells:
        cost = c["cost"]
        t = roofline_terms({"flops": cost["flops"],
                            "bytes accessed": cost["hbm_bytes"]},
                           cost["wire_bytes"], hw=H100, dtype="bf16",
                           model_flops=c["model_flops"])
        label = f"roofline {c['arch']} {c['shape']}"
        if not (t.flops > 0 and t.hbm_bytes > 0):
            raise AssertionError(f"{label}: counted {t.flops} flops, "
                                 f"{t.hbm_bytes} bytes")
        share = _share(label, t.bound_s * 1e3, c["ms"])
        row = dict({k: v for k, v in c.items() if k != "cost"},
                   transcendentals=cost["transcendentals"],
                   count_s=cost["count_s"], roofline=t.as_dict(),
                   bound_ms=t.bound_s * 1e3, bound_share=share,
                   mfu_measured=t.model_flops / (c["ms"] / 1e3
                                                 * t.peak_flops),
                   counted_util=t.flops / (c["ms"] / 1e3 * t.peak_flops),
                   mfu_overcount=t.useful_fraction > 1)
        out.append(row)
        log(f"  {c['arch']} {c['shape']}: {t.flops:.4e} flops, "
            f"{t.hbm_bytes:.4e} B → compute {t.compute_s * 1e3:.3f} ms, "
            f"memory {t.memory_s * 1e3:.3f} ms ({t.dominant}-bound); "
            f"measured {c['ms']:.2f} ms = {share:.1%} of the bound; useful "
            f"{t.useful_fraction:.3f}; MFU {row['mfu_measured']:.1%} "
            f"measured"
            + (" (an overcount: useful > 1)" if row["mfu_overcount"]
               else "")
            + f", {t.mfu_at_roofline:.1%} at the bound; counted flops at "
            f"{row['counted_util']:.1%} of the peak")
    log(format_table([dict(arch=r["arch"], shape=r["shape"],
                           roofline=r["roofline"]) for r in out]))
    return out


# ------------------------------------------------------------- phase 15
EXAMPLES = ROOT / "examples_torch"
#: train_lm_cggn's arguments on the card: the 25m config at the script's
#: sequence length and batch, its steps cut to keep the phase near 90 s
EXAMPLE_TRAIN = ("--size", "25m", "--steps", "100", "--cggn-steps", "10")
#: the CUDA kernels of the solver example's ``backend="pallas"`` run, by
#: a part of their names in the profiler, and the launch counters of the
#: wrappers that launch them (the batched ELLPACK wrapper shares the SpMV)
EXAMPLE_KERNELS = {"spmv_ellpack_": ("spmv_ell", "spmv_ellpack"),
                   "dot_chunks": ("dot",), "phase2_chunks": ("phase2",),
                   "phase3_kernel": ("phase3",)}


def _example(name: str):
    """``examples_torch/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_run(label: str, fn):
    """``fn()`` timed on the card, with a header line."""
    import torch
    log(f"  --- {label}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _tour_solves(tour) -> dict:
    """``{label: (iterations, status)}`` of the solver tour's solves."""
    out = {f"{k}/{n}": (r.iterations, _exit_status(r, SUITE_MAXITER))
           for k in ("schemes", "methods", "backends")
           for n, r in tour[k].items()}
    out["phase_loop"] = (tour["phase_loop"].iterations,
                         _exit_status(tour["phase_loop"], SUITE_MAXITER))
    out.update({f"vm/{p}": (int(r["iterations"]),
                            "CONVERGED" if r["converged"] else "STOPPED")
                for p, r in tour["vm"].items()})
    return out


def _example_slack(label: str, host_iters: int) -> int:
    """Iterations a solve of the examples may differ by, card against
    host.  The kernels are their plain versions bit for bit and the VSR
    loop sums in the port's own order, so a solve matches exactly, but:
    pipelined sums its dots with ``torch.dot``, whose order differs
    between the devices (±2, tests/test_torch_cg.py's rule); the batched
    VM's plain sums may differ in a last bit (phase 4's ±1); and the plain
    ``xla`` SpMV at mixed_v1 sums fp32 products through
    ``index_put_(accumulate=True)``, sorted on the card and in row order on
    the host, which moves ``poisson_2d(48)`` from 108 iterations to 100
    (the reference's own ``xla`` and ``pallas`` take 108 and 101 there):
    10 % of the host's."""
    if "pipelined" in label:
        return 2
    if "/vm/" in label:
        return 1
    if label.endswith("/mixed_v1"):
        return max(1, host_iters // 10)
    return 0


def phase_examples(dev, card, ops) -> tuple:
    """The four examples in-process on ``cuda:0`` through their ``main``,
    then the solver and serving ones again with ``--device cpu``.
    Returns ``(launches, record)``: the counts of the card runs (set to 0
    before them and read after) and the phase's figures."""
    t_phase = time.perf_counter()
    mods = {n: _example(n) for n in ("quickstart", "solve_poisson",
                                     "serve_decode", "train_lm_cggn")}
    cuda, walls, per = {}, {}, {}
    ops.reset_launches()
    seen = ops.launches()
    for name, argv in (("quickstart", ["--device", "cuda"]),
                       ("solve_poisson", ["--device", "cuda"]),
                       ("serve_decode", ["--device", "cuda"]),
                       ("train_lm_cggn", [*EXAMPLE_TRAIN, "--device",
                                          "cuda"])):
        run = lambda: mods[name].main(argv)        # noqa: E731
        if name == "solve_poisson":
            (cuda[name], walls[name]), _, ev = device_profile(
                lambda: _example_run(f"{name} {' '.join(argv)} "
                                     "(profiled)", run))
        else:
            cuda[name], walls[name] = _example_run(
                f"{name} {' '.join(argv)}", run)
        now = ops.launches()
        per[name] = {k: now[k] - seen.get(k, 0) for k in now
                     if now[k] != seen.get(k, 0)}
        seen = now
        log(f"  {name}: {walls[name]:.2f} s on the card, launches "
            f"{per[name]}")
    launches = ops.launches()

    # the solver example's kernels as the profiler sees them
    profiled = {}
    for prefix, counters in EXAMPLE_KERNELS.items():
        c = sum(c for key, _, c in ev if prefix in key)
        n = sum(per["solve_poisson"].get(k, 0) for k in counters)
        profiled[prefix] = dict(profiled=c, launched=n)
        if not (n > 0 and 0.9 * n <= c <= n):
            raise AssertionError(f"solve_poisson: {prefix}* launched {n} "
                                 f"times, {c} in the profile")
    log(f"  solve_poisson profile, kernels seen / launched: "
        + ", ".join(f"{k}* {v['profiled']} / {v['launched']}"
                    for k, v in profiled.items()))

    # the same examples on the host: iterations, statuses, tokens
    cpu = {}
    for name, argv in (("quickstart", ["--device", "cpu"]),
                       ("solve_poisson", ["--device", "cpu"]),
                       ("serve_decode", ["--device", "cpu"])):
        log(f"  --- {name} {' '.join(argv)}")
        t0 = time.perf_counter()
        cpu[name] = mods[name].main(argv)
        walls[f"{name}/cpu"] = time.perf_counter() - t0
    solves = {}
    for dev_name, res in (("cuda", cuda), ("cpu", cpu)):
        q = res["quickstart"]
        solves[dev_name] = {
            **{f"quickstart/{s}": (q[s].iterations,
                                   _exit_status(q[s], SUITE_MAXITER))
               for s in ("mixed_v3", "fp64", "mixed_v1")},
            **{f"solve_poisson/{k}": v
               for k, v in _tour_solves(res["solve_poisson"]).items()}}
    bad = []
    for label, (it, status) in solves["cuda"].items():
        c_it, c_status = solves["cpu"][label]
        slack = _example_slack(label, c_it)
        log(f"    {label:34s} card {status} {it:5d}   host {c_status} "
            f"{c_it:5d}   (±{slack})")
        if status != "CONVERGED" or c_status != "CONVERGED" \
                or abs(it - c_it) > slack:
            bad.append(f"{label}: card {status}/{it}, host {c_status}/"
                       f"{c_it} (±{slack})")
    if bad:
        raise AssertionError("examples: " + "; ".join(bad))
    tokens = {d["arch"]: d["tokens"] for d in cuda["serve_decode"]}
    c_tokens = {d["arch"]: d["tokens"] for d in cpu["serve_decode"]}
    if tokens != c_tokens:
        raise AssertionError(f"serve_decode tokens: card {tokens}, host "
                             f"{c_tokens}")
    train = cuda["train_lm_cggn"]
    adamw = [r["loss"] for r in train["adamw"]]
    cggn = [r["loss"] for r in train["cggn"]]
    if not (all(map(math.isfinite, adamw + cggn)) and adamw[-1] < adamw[0]
            and cggn[-1] < cggn[0]):
        raise AssertionError(f"train_lm_cggn: AdamW {adamw[0]:.4f} -> "
                             f"{adamw[-1]:.4f}, CGGN {cggn[0]:.4f} -> "
                             f"{cggn[-1]:.4f}")
    wall = time.perf_counter() - t_phase
    log(f"  {len(solves['cuda'])} solves CONVERGED on both devices, "
        "iterations equal (pipelined ±2, VM ±1, mixed_v1 on xla ±10 %); "
        "decode tokens "
        f"{tokens} on both; AdamW loss {adamw[0]:.4f} -> {adamw[-1]:.4f}, "
        f"CGGN {cggn[0]:.4f} -> {cggn[-1]:.4f}")
    log(f"  examples phase {wall:.1f} s on {card}; "
        + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))
    return launches, dict(
        wall_s=wall, walls_s=walls, launches=per, profiled=profiled,
        solves={k: {"cuda": v, "cpu": solves["cpu"][k]}
                for k, v in solves["cuda"].items()},
        decode_tokens=tokens, adamw_loss=[adamw[0], adamw[-1]],
        cggn_loss=[cggn[0], cggn[-1]], card=card)


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
    from repro_torch.kernels import _build, ops
    from repro_torch.sparse import poisson_2d

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    # full fp32 products in every plain version (cuBLAS and cuDNN)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s into {_build.build_dir()}")
    phase_build(libs)

    t0 = time.perf_counter()
    bag = smoke_bag()
    log(f"[data] bag G={len(bag)} n={[a.shape[0] for a in bag]}"
        f" nnz={[a.nnz for a in bag]} in {time.perf_counter() - t0:.1f} s")

    # the kernels each path must launch (the tier's instantiations of
    # spmv_sell and spmv_ellpack on the batched path, tpu_v3's spmv_ell on
    # the single-system one; the packer's two passes at the engine's
    # ELLPACK admissions and the single-system operator build)
    tier = lambda k: tuple(f"{k}[{s}]" for s in TIER)   # noqa: E731
    packer = ("ellpack_geometry", "ellpack_scatter")
    paths = {"solve": ("spmv_sell", "spmv_ellpack") + tier("spmv_sell")
             + tier("spmv_ellpack"),
             "engine": ("spmv_sell", "spmv_ellpack") + packer,
             "single": ("spmv_ell", "dot", "phase2", "phase3",
                        "spmv_ell[tpu_v3]") + packer,
             "sharded": ("spmv_sell", "spmv_ellpack"),
             "lm": FLASH_PATH, "families": FLASH_PATH, "whisper": FLASH_PATH,
             "suite": ("spmv_ell", "dot", "phase2", "phase3"),
             "examples": ("spmv_ell", "dot", "phase2", "phase3",
                          "spmv_sell")}
    launches = {}
    log_phase("[phase 1] kernels against their plain versions")
    timed = phase_kernels(bag, dev)
    log_phase("[phase 2] batched solve (faithful schemes, generic VM, the "
              "tier)")
    ops.reset_launches()
    solve_rows, _, main_results = phase_solve(bag, dev)
    launches["solve"] = ops.launches()
    log(f"  launches {launches['solve']}")
    log_phase("[phase 3] SolverEngine, and one generic engine under two "
              "policies")
    ops.reset_launches()
    phase_engine(bag, dev)
    phase_engine_generic(bag, dev)
    launches["engine"] = ops.launches()
    log(f"  launches {launches['engine']}")
    log_phase("[phase 4] card against CPU")
    phase_cross_device(dev)

    t0 = time.perf_counter()
    single = poisson_2d(SINGLE_NX)
    log(f"[data] poisson_2d({SINGLE_NX}): n={single.shape[0]} "
        f"nnz={single.nnz} in {time.perf_counter() - t0:.1f} s")
    log_phase("[phase 5] single-system kernels against their plain "
              "versions")
    timed.update(phase_single_kernels(single, dev))
    log_phase("[phase 5b] the CSR-to-ELLPACK packer against its plain "
              "version")
    timed.update(phase_pack(single, dev))
    log_phase("[phase 6] single-system solve")
    launches["single"], single_res, single_loops = phase_single_solve(single,
                                                                      dev)
    log(f"  launches {launches['single']}")
    log_phase("[phase 6b] lane-sharded batched solve (D = 1 and D = 2 on "
              "one card)")
    ops.reset_launches()
    sharded = phase_sharded(bag, dev, main_results,
                            solve_rows[0]["ms_per_tick"])
    launches["sharded"] = ops.launches()
    log(f"  launches {launches['sharded']}")
    del main_results
    log_phase("[phase 6c] row-distributed CG (NCCL, world size 1)")
    ops.reset_launches()
    distributed = phase_distributed(single, dev, single_res, single_loops)
    launches["distributed"] = ops.launches()
    log(f"  launches {launches['distributed']}")
    del single_res
    log_phase(f"[phase 7] flash_attention against its plain version ({ARCH} "
              "shapes)")
    timed["flash_attention"], flash_timed, flash_err = phase_flash(dev)
    timed.update(flash_entries(timed["flash_attention"], flash_timed,
                               flash_err))
    log_phase(f"[phase 8] {ARCH} at full width, {GEMMA_LAYERS} of 26 layers: "
              "forward, kernel composition")
    ops.reset_launches()
    params, lm = phase_lm_forward(dev)
    launches["lm"] = ops.launches()
    log(f"  launches {launches['lm']}")
    log_phase(f"[phase 9] DecodeEngine on {ARCH} at full width, "
              f"{GEMMA_LAYERS} of 26 layers")
    lm["engine"] = phase_engine_lm(params, dev)
    del params
    log_phase(f"[phase 10] training {ARCH} at full width, {GEMMA_LAYERS} of "
              "26 layers: AdamW, resume, "
              "microbatches, CGGN")
    ops.reset_launches()
    train = phase_train(dev)
    launches["train"] = ops.launches()
    log(f"  launches {launches['train']} (no kernel on the training path)")
    log_phase(f"[phase 10b] the sharded train step on a (1, 1) mesh "
              f"(NCCL, world size 1), {ARCH} at phase 10's shapes")
    ops.reset_launches()
    train["mesh"] = phase_mesh_train(dev, card)
    launches["mesh"] = ops.launches()
    log(f"  launches {launches['mesh']} (no kernel on the training path)")
    log_phase("[phase 11] the MoE, SSM and hybrid families at full width "
              f"({', '.join(FAMILIES)}; {LLAMA4} at {LLAMA4_LAYERS} layers)")
    ops.reset_launches()
    families = phase_families(dev, card)
    launches["families"] = ops.launches()
    log(f"  launches {launches['families']}")
    families["flash_attention"] = phase_families_flash(dev)
    log_phase(f"[phase 12] {WHISPER} at full width (encoder-decoder), the "
              "int8 KV cache")
    ops.reset_launches()
    whisper = phase_whisper(dev, card)
    launches["whisper"] = ops.launches()
    log(f"  launches {launches['whisper']}")
    whisper["flash_attention"] = phase_whisper_flash(dev)
    log_phase("[phase 13] the paper's Tables 4, 5 and 7: jpcg_solve over "
              "the 12-matrix suite")
    ops.reset_launches()
    suite = phase_suite(dev)
    launches["suite"] = ops.launches()
    log(f"  launches {launches['suite']}")
    log_phase("[phase 14] roofline terms of the LM cells (H100, bf16)")
    cells = [lm.pop("cell"), lm["engine"].pop("cell"), train.pop("cell")]
    for arch in FAMILIES:
        cells += [families[arch].pop("cell"),
                  families[arch]["train"].pop("cell")]
    wb, ws = WHISPER_PREFILL[0]
    cells.append(whisper["prefill"][f"B{wb}xS{ws}"].pop("cell"))
    roofline = phase_roofline(cells)
    log_phase("[phase 15] the four examples (examples_torch/) on the card "
              "and on the host")
    launches["examples"], examples = phase_examples(dev, card, ops)
    log(f"  launches {launches['examples']}")
    for path, names in paths.items():
        for name in names:
            if launches[path][name] <= 0:
                raise AssertionError(f"{name} never launched on the {path} "
                                     "path")
    for path in ("lm", "families", "whisper"):
        if launches[path]["flash_attention[fp32]"]:
            raise AssertionError(f"the {path} path launched the CUDA-core "
                                 "fp32 kernel: its fp32 compositions must "
                                 "take tf32x3")

    csrc = "src/repro_torch/kernels/csrc/"
    sources = {"spmv_sell": "spmv_sell.cu", "spmv_ellpack": "spmv_ellpack.cu",
               "spmv_ell": "spmv_ellpack.cu", "dot": "dot.cu",
               "dot3": "dot.cu", "phase2": "fused_phase.cu",
               "phase3": "fused_phase.cu",
               "flash_attention[wgmma]": "flash_attn_sm90.cu",
               "flash_attention[mma_sync]": "flash_attn.cu",
               "flash_attention[tf32x3]": "flash_attn_tf32.cu",
               "flash_attention[fp32]": "flash_attn.cu",
               "ellpack_pack": "ellpack_pack.cu"}
    sources = {name: csrc + src for name, src in sources.items()}
    # the total of the four routes: the wrapper, whose ``_route`` picks the
    # source of each launch (its row names them all)
    sources["flash_attention"] = "src/repro_torch/kernels/flash_attn.py"
    timed["flash_attention"]["sources"] = [csrc + "flash_attn_sm90.cu",
                                           csrc + "flash_attn.cu",
                                           csrc + "flash_attn_tf32.cu"]
    replaces = {"spmv_sell": "src/repro/kernels/spmv.py:179",
                "spmv_ellpack": "src/repro/kernels/spmv.py:123",
                "spmv_ell": "src/repro/kernels/spmv.py:68",
                "dot": "src/repro/kernels/dot.py:60",
                "dot3": "src/repro/kernels/dot.py:106",
                "phase2": "src/repro/kernels/fused_phase.py:62",
                "phase3": "src/repro/kernels/fused_phase.py:106",
                "flash_attention": "src/repro/kernels/flash_attn.py:90",
                # none: the JAX package packs on the host
                "ellpack_pack": None}
    for name in FLASH_ROUTES:
        replaces[name] = replaces["flash_attention"]
    # each tier instantiation of the three SpMVs is an entry of its own
    for k in ("spmv_sell", "spmv_ellpack", "spmv_ell"):
        for name in tier(k):
            sources[name], replaces[name] = sources[k], replaces[k]
    # a pack is a geometry launch, then a scatter: count the scatters
    counted = {"ellpack_pack": "ellpack_scatter"}
    kernels = []
    for name, src in sources.items():
        t = timed[name]
        _share(name, t["bound_ms"], t["ms"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": src,
            "replaces": replaces[name],
            "launches": sum(c.get(counted.get(name, name), 0)
                            for c in launches.values()),
            **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            **{k: t[k] for k in ("bound_stored_ms", "bound_streamed_ms",
                                 "streamed_slots", "class_ms", "ms_fp64",
                                 "bound_ms_fp64", "library_dtype", "shape",
                                 "sizes", "sources", "partner",
                                 "partner_ms", "prepass_ms", "main_ms",
                                 "prepass_bytes")
               if k in t}})
    lm["flash_attention"] = flash_timed
    print(json.dumps({"sharded": sharded, "distributed": distributed}),
          flush=True)
    print(json.dumps({"lm": lm}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"families": families}), flush=True)
    print(json.dumps({"whisper": whisper}), flush=True)
    print(json.dumps({"suite": suite}), flush=True)
    print(json.dumps({"roofline": roofline}), flush=True)
    print(json.dumps({"examples": examples}), flush=True)
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
