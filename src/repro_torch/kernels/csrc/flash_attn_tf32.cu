// Flash attention (forward), fp32, for Hopper (sm_90a): each fp32 product as
// three TF32 products on wgmma.  Replaces the Pallas kernel
// repro/kernels/flash_attn.py::flash_attention (body _kernel) for fp32 inputs
// whose head dim is a multiple of 4 and whose base pointers are 16-byte
// aligned (16-byte loads of every row); repro_torch.kernels.flash_attn.
// _route picks it by shape, and csrc/flash_attn.cu's CUDA-core kernel takes
// the other fp32 inputs, D <= 32 among them: _route's carve-out for the
// reference test's x30-logit case (at logits near 1e3 its 1e-4 gate holds
// with q.k summed as that kernel sums it, and misses on some inputs in any
// other order, this kernel's included).  Its plain version is
// repro_torch.kernels.flash_attn.flash_attention_plain (the reference's
// kernels/ref.py::mha_ref).
//
// What it computes is the reference kernel's step, per live 64-key tile:
// s = q.k scaled, masked to -1e30 (keys past T: -inf); online softmax; output
// acc / max(l, 1e-30).  The numeric route: every operand x is split into
// hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (the subtraction is
// exact), and a product x y is taken as x_lo y_hi + x_hi y_lo + x_hi y_hi,
// small terms first, in fp32 wgmma accumulators (m64n64k8 .tf32); the
// dropped x_lo y_lo is about 2^-22 of the product.  The operands are rounded
// explicitly: nothing relies on the tensor cores ignoring a tf32 operand's
// low 13 bits.  The softmax runs in base 2 on scores pre-scaled by
// D^-0.5 log2(e) (ex2.approx.f32; exp2f compiles to the same MUFU.EX2 under
// these flags), as csrc/flash_attn_sm90.cu's, whose barriers, descriptors
// and softmax it shares through csrc/sm90.cuh; l sums the fp32 p.
//
// Bound: operations on the tensor cores, 3 x 4 D flops a live (query, key)
// pair at the dense TF32 peak (494.7 TFLOP/s), and beside it the bytes of
// q, k, v, o and of the split K and V this route writes and reads back.
//
// Design.  Where it was hard, and what it does:
// 1. tf32 wgmma takes only K-major operands (no transposition: that is for
//    16-bit types), so P V needs V^T with each head column's keys
//    contiguous, which a TMA box of V cannot give.  A pre-pass kernel
//    (split_kv) reads K and V once a call and writes, for each 64-key tile
//    and 64-column chunk of D, K_hi / K_lo and V^T_hi / V^T_lo as the exact
//    shared-memory image a wgmma operand wants (K-major, 128-byte swizzle;
//    keys and columns past T and D zero) into scratch the wrapper allocates.
//    The main kernel moves each 32 KB image with one bulk copy (the TMA
//    unit's 1-D mode) into a ring of slots.
// 2. The f32 accumulator gives a thread keys 2 t4 and 2 t4 + 1 of each
//    8-key step (t4 = lane % 4) where the tf32 A fragment wants columns t4
//    and t4 + 4 (PTX ISA, wgmma .m64nNk8 A fragment: a0 (g, t4),
//    a1 (g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4)).  Since P V sums
//    over keys, V^T's keys are stored permuted instead (within each group of
//    8: 0 2 4 6 1 3 5 7), so column t4 carries key 2 t4 and t4 + 4 key
//    2 t4 + 1, and P goes from the score registers to the A fragments with
//    no shuffle, split into hi and lo in registers.
// 3. Shared memory: Q is split once a block by the consumers themselves
//    (plain 16-byte loads, hi and lo stored in the swizzled layout, then a
//    proxy fence), so S = Q K^T has both operands in shared memory.  Q as
//    hi/lo is 64 x D x 8 bytes a consumer warpgroup: 128 KB at D = 256,
//    which leaves room for one consumer warpgroup (64 query rows) and three
//    32 KB slots; at D <= 128 two consumer warpgroups (128 rows) share three
//    (D = 128) or five (D = 64) slots.  A slot holds one 64-column chunk of
//    a tile's K or V^T (hi then lo), so the ring streams D in chunks and
//    every product is an m64n64k8.
// 4. The producer is a whole warpgroup (setmaxnreg needs whole warpgroups;
//    with two consumers they rise to 232 registers), one thread of which
//    issues the bulk copies.  Every mbarrier wait is sm90.cuh's PTX loop, and
//    every descriptor a base plus a constant at the issue.
// 5. A tile's products are issued chunk by chunk, the next chunk's before
//    the last one's wait, so one chunk is in flight while its slot's
//    successor arrives; the mask is decided once a tile (sm90.cuh's
//    online_softmax) and O is rescaled only when a row's max moved.
// Tiles wholly dead for the block are skipped; rows past S and columns past D
// are not written.
//
// Measured (chip_smoke.py, phases 7, 11 and 12, on an H100 80GB HBM3 at
// 700 W): gemma3-1b's global layer in fp32 (BH 8, S 4,096, D 256, causal) in
// 0.78 ms, 53 % of the bound, against 4.56 ms for the CUDA-core kernel and
// 2.09 ms for scaled_dot_product_attention; the D = 64 shapes in 51-57 %.
// At D = 256 the ring reads 256 KB of slot images from L2 for every 64 x 64
// tile of its one consumer; two blocks of a cluster sharing each slot by
// multicast (half those reads) were slower, as was a ping-pong of the two
// consumers at D <= 128 (as the bf16 kernel's), so neither is kept.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"      // barriers, copies, wgmma fences, descriptors, the online softmax
#include "tree_sum.cuh"  // repro_cuda_error_string

namespace {

using namespace sm90;

constexpr int kBK = 64;                         // keys a tile
constexpr int kSlotFloats = 2 * kBK * 64;       // a slot: one 64-column chunk, hi then lo
constexpr int kSlotBytes = kSlotFloats * 4;     // 32 KB
constexpr int kHalfBytes = 64 * kRowBytes;      // 32 columns (128 B) of 64 rows
constexpr int kBarBytes = 128;

// Shared memory of the DP instantiation: each consumer's Q [hi, lo][DP / 32]
// [64 rows][128 B], then the slots, each [hi, lo][2][64 rows][128 B] (K: rows
// are keys, 32 columns a half; V^T: rows are head columns, 32 keys a half),
// then the barriers.  Every tile starts on 1,024 bytes.
template <int DP>
struct Plan {
  static constexpr int kCons = DP == 256 ? 1 : 2;  // consumer warpgroups
  static constexpr int kThreads = 128 * (kCons + 1);
  static constexpr int kBQ = 64 * kCons;           // query rows a block
  static constexpr int kNC = DP / 64;              // 64-column chunks of D
  static constexpr int kQWgBytes = 64 * DP * 8;    // one consumer's Q, hi and lo
  static constexpr int kQBytes = kCons * kQWgBytes;
  static constexpr int kSlots = (kSmemLimit - 1024 - kBarBytes - kQBytes) / kSlotBytes;
  static constexpr int kSmem = 1024 + kQBytes + kSlots * kSlotBytes + kBarBytes;
  static_assert(kSlots >= 2 && kSmem <= kSmemLimit, "two slots must fit");
  static_assert(2 * kSlots * 8 <= kBarBytes, "the barriers must fit");
};

// d (64 x 64 fp32) += A (64 x 8 tf32, K-major, shared) * B (64 x 8 tf32,
// K-major, shared); scale_d 0 ignores d's old values
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64 fp32) += A (64 x 8 tf32, registers) * B (64 x 8 tf32, K-major, shared)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ------------------------------------------------------------ arithmetic
// x rounded to tf32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x -> hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

// The byte offset of 16-byte unit j (columns 4 j .. 4 j + 3) of row r in a
// [halves][64 rows][128 B] tile with the 128-byte swizzle (unit j % 8 of a
// row stored at (j % 8) ^ (r % 8))
__device__ __forceinline__ int swizzled(int r, int j) {
  return (j / 8) * kHalfBytes + r * kRowBytes + (((j % 8) ^ (r & 7)) << 4);
}

// ------------------------------------------------------------ the pre-pass
// One slot image a block: slot index ((bh n_kt + kt) 2 + kv) NC + c holds
// chunk c (64 columns of D) of tile kt (64 keys) of K (kv 0: rows are keys)
// or of V^T (kv 1: rows are head columns, keys permuted within each group of
// 8 as 0 2 4 6 1 3 5 7), hi (the first 16 KB) and lo, each [2 halves][64
// rows][32 columns] in the 128-byte swizzle of a 1,024-byte-aligned tile.
template <int NC>
__global__ void __launch_bounds__(256)
    split_kv(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ tiles,
             int t_len, int d, int n_kt) {
  __shared__ float tile[kBK][65];  // [key][column], +1 against bank conflicts
  const long long slot = blockIdx.x;
  const int c = static_cast<int>(slot % NC);
  const int kv = static_cast<int>((slot / NC) % 2);
  const long long kt_bh = slot / (2 * NC);
  const int kt = static_cast<int>(kt_bh % n_kt);
  const long long bh = kt_bh / n_kt;
  const float* src = (kv ? v : k) + bh * t_len * d;
  const int tid = threadIdx.x;
  for (int i = tid; i < kBK * 16; i += 256) {
    const int r = i / 16, j = i % 16, key = kt * kBK + r, col = 64 * c + 4 * j;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    // d % 4 == 0: a unit is wholly inside D or wholly past it
    if (key < t_len && col < d) {
      x = *reinterpret_cast<const float4*>(src + static_cast<long long>(key) * d + col);
    }
    tile[r][4 * j] = x.x;
    tile[r][4 * j + 1] = x.y;
    tile[r][4 * j + 2] = x.z;
    tile[r][4 * j + 3] = x.w;
  }
  __syncthreads();
  float* dst = tiles + slot * kSlotFloats;
  for (int i = tid; i < 64 * 16; i += 256) {
    const int r = i / 16, j = i % 16;  // image row r, positions 4 j .. 4 j + 3
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 4 * j + e;
      if (kv == 0) {
        x[e] = tile[r][p];
      } else {
        x[e] = tile[(p & ~7) + 2 * (p & 3) + ((p >> 2) & 1)][r];
      }
    }
    uint4 hi, lo;
    split4(make_float4(x[0], x[1], x[2], x[3]), hi, lo);
    const int off = swizzled(r, j) / 4;
    *reinterpret_cast<uint4*>(dst + off) = hi;
    *reinterpret_cast<uint4*>(dst + kSlotFloats / 2 + off) = lo;
  }
}

// ------------------------------------------------------------ the products
// S (64 x 64 keys) += Q K^T over chunk c (64 columns) of D: Q_lo K_hi, then
// Q_hi K_lo, then Q_hi K_hi, each over the chunk's eight 8-column steps;
// scale_d 0 on the tile's first product
__device__ __forceinline__ void qk_chunk(float (&sc)[32], uint32_t q_hi, uint32_t q_lo,
                                         uint32_t slot, int c) {
  const uint64_t a_hi = desc(q_hi + c * 2 * kHalfBytes, 16, 8 * kRowBytes);
  const uint64_t a_lo = desc(q_lo + c * 2 * kHalfBytes, 16, 8 * kRowBytes);
  const uint64_t b_hi = desc(slot, 16, 8 * kRowBytes);
  const uint64_t b_lo = desc(slot + kSlotBytes / 2, 16, 8 * kRowBytes);
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t off = (j / 4) * kHalfBytes + (j % 4) * 32;
      wgmma_tf32(sc, desc_at(pass == 0 ? a_lo : a_hi, off),
                 desc_at(pass == 1 ? b_lo : b_hi, off), c > 0 || pass > 0 || j > 0);
    }
  }
}

// O chunk (64 x 64 head columns) += P V^T's chunk over the tile's 64 keys:
// P_lo V_hi, then P_hi V_lo, then P_hi V_hi, P from registers
__device__ __forceinline__ void pv_chunk(float (&o)[32], const uint32_t (&ph)[8][4],
                                         const uint32_t (&pl)[8][4], uint32_t slot) {
  const uint64_t b_hi = desc(slot, 16, 8 * kRowBytes);
  const uint64_t b_lo = desc(slot + kSlotBytes / 2, 16, 8 * kRowBytes);
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t off = (j / 4) * kHalfBytes + (j % 4) * 32;
      wgmma_tf32(o, pass == 0 ? pl[j] : ph[j], desc_at(pass == 1 ? b_lo : b_hi, off));
    }
  }
}

// p -> the A fragments of P V, hi and lo: step j takes keys 8 j .. 8 j + 7,
// of which this thread holds 8 j + 2 t4 (score registers 4 j, 4 j + 2: rows
// g, g + 8) and 8 j + 2 t4 + 1 (4 j + 1, 4 j + 3); they go to fragment
// columns t4 (a0, a1) and t4 + 4 (a2, a3), the order V^T's keys are stored in
template <int KS>
__device__ __forceinline__ void split_all(const float (&sc)[4 * KS], uint32_t (&ph)[KS][4],
                                          uint32_t (&pl)[KS][4]) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    split(sc[4 * j], ph[j][0], pl[j][0]);
    split(sc[4 * j + 2], ph[j][1], pl[j][1]);
    split(sc[4 * j + 1], ph[j][2], pl[j][2]);
    split(sc[4 * j + 3], ph[j][3], pl[j][3]);
  }
}

// This warpgroup's 64 rows of Q from global memory (rows past S and columns
// past D as zeros), split into hi and lo in shared memory, each [DP / 32]
// [64 rows][128 B] in the swizzled layout; then visible to wgmma
template <int DP>
__device__ __forceinline__ void load_q(const float* __restrict__ qb, int wq0, int s_len, int d,
                                       int wt, uint32_t q_hi, uint32_t q_lo) {
  constexpr int kUnits = DP / 4;  // 16-byte units a row
#pragma unroll 4
  for (int i = wt; i < 64 * kUnits; i += 128) {
    const int r = i / kUnits, j = i % kUnits, row = wq0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < s_len && 4 * j < d) {
      x = *reinterpret_cast<const float4*>(qb + static_cast<long long>(row) * d + 4 * j);
    }
    uint4 hi, lo;
    split4(x, hi, lo);
    const uint32_t off = swizzled(r, j);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(q_hi + off), "r"(hi.x),
                 "r"(hi.y), "r"(hi.z), "r"(hi.w)
                 : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(q_lo + off), "r"(lo.x),
                 "r"(lo.y), "r"(lo.z), "r"(lo.w)
                 : "memory");
  }
  // the generic proxy's stores, before the async proxy's (wgmma's) reads
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ------------------------------------------------------------ the kernel
template <int DP>
__global__ void __launch_bounds__(Plan<DP>::kThreads, 1)
    flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ tiles,
                   float* __restrict__ out, int s_len, int t_len, int d, int n_bh, int causal,
                   long long window, float scale_log2) {
  using P = Plan<DP>;
  constexpr int kCons = P::kCons, kBQ = P::kBQ, NC = P::kNC, kSlots = P::kSlots;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + P::kQBytes;  // slot s at ring + s kSlotBytes
  const uint32_t bar_s = ring + kSlots * kSlotBytes;
  auto full = [&](int s) { return bar_s + 8u * s; };
  auto empty = [&](int s) { return bar_s + 8u * (kSlots + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // block b takes query tile n_qt - 1 - b / n_bh of head b % n_bh: the
  // heaviest causal tiles of every head start first
  const int n_qt = (s_len + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / n_bh)) * kBQ;
  const int bh = static_cast<int>(blockIdx.x % n_bh);

  // the block's live K tiles are [kt_lo, kt_lo + n_tiles)
  const int q_last = min(q0 + kBQ, s_len) - 1;
  const int n_kt = (t_len + kBK - 1) / kBK;
  const int kt_hi = causal ? min(n_kt, q_last / kBK + 1) : n_kt;
  int kt_lo = 0;
  if (window >= 0) {
    const long long dead = q0 - window;  // keys <= dead are dead for every row here
    if (dead >= 0) kt_lo = t_len - 1 <= dead ? kt_hi : static_cast<int>((dead + 1) / kBK);
  }
  const int n_tiles = max(kt_hi - kt_lo, 0);

  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kCons);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kCons) {
    // ---------------------------------------------------- the producer
    if constexpr (kCons > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 4 * kCons && lane == 0) {
      // the live tiles' slot images are contiguous: K's chunks, then V^T's,
      // tile after tile, the order the consumers take them in
      const float* src = tiles + (static_cast<long long>(bh) * n_kt + kt_lo) * 2 * NC * kSlotFloats;
      int slot = 0;
      unsigned phase = 0;
      for (int n = 0; n < n_tiles * 2 * NC; ++n) {
        mbar_wait(empty(slot), phase ^ 1u);  // the first round passes at once
        mbar_expect(full(slot), kSlotBytes);
        bulk_copy(ring + slot * kSlotBytes, src + static_cast<long long>(n) * kSlotFloats,
                  kSlotBytes, full(slot));
        if (++slot == kSlots) {
          slot = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ---------------------------------------------------- the consumers
    if constexpr (kCons > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp / 4;
    const int t4 = lane & 3;
    const int wq0 = q0 + 64 * wg;
    const int row0 = wq0 + 16 * (warp & 3) + (lane >> 2);  // this thread's rows: row0, row0 + 8
    const uint32_t q_hi = base + wg * P::kQWgBytes, q_lo = q_hi + P::kQWgBytes / 2;
    const Mask mask{t_len, causal, window, wq0, row0, t4, scale_log2};

    float o[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    }
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    uint32_t ph[8][4], pl[8][4];
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, corr[2];

    if (n_tiles > 0) {
      load_q<DP>(q + static_cast<long long>(bh) * s_len * d, wq0, s_len, d, tid & 127, q_hi,
                 q_lo);
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");  // this warpgroup's Q is in
      int slot = 0;
      unsigned phase = 0;
      // release the slot a finished chunk read
      auto release = [&](int s) {
        if (lane == 0) mbar_arrive(empty(s));
      };
      for (int n = 0; n < n_tiles; ++n) {
        // S = Q K^T, a chunk of D a slot; the next chunk issues before the
        // last one's wait
        int prev = 0;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          mbar_wait(full(slot), phase);
          if (c == 0) keep(sc);  // later chunks: sc is in flight
          wg_fence();
          qk_chunk(sc, q_hi, q_lo, ring + slot * kSlotBytes, c);
          wg_commit();
          if (c > 0) {
            wg_wait<1>();
            release(prev);
          }
          prev = slot;
          if (++slot == kSlots) {
            slot = 0;
            phase ^= 1u;
          }
        }
        wg_wait<0>();
        keep(sc);
        release(prev);
        online_softmax(sc, m, l, corr, (kt_lo + n) * kBK, mask);
        // a factor of exactly 1 for every row of the warp leaves o as it is
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
#pragma unroll
            for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];
          }
        }
        split_all(sc, ph, pl);
        // O += P V, a chunk of D a slot
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          mbar_wait(full(slot), phase);
          keep(o[c]);
          if (c == 0) {  // later chunks: ph and pl are in flight
            keep(ph);
            keep(pl);
          }
          wg_fence();
          pv_chunk(o[c], ph, pl, ring + slot * kSlotBytes);
          wg_commit();
          if (c > 0) {
            wg_wait<1>();
            release(prev);
          }
          prev = slot;
          if (++slot == kSlots) {
            slot = 0;
            phase ^= 1u;
          }
        }
        wg_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c) keep(o[c]);
        keep(ph);
        keep(pl);
        release(prev);
      }
    }

    float* ob = out + static_cast<long long>(bh) * s_len * d;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row0 + 8 * h;
      if (row >= s_len) continue;
      const float den = fmaxf(l[h], 1e-30f);
      float* orow = ob + static_cast<long long>(row) * d;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + 2 * t4;  // d is even: both columns or neither
          if (col < d) {
            *reinterpret_cast<float2*>(orow + col) =
                make_float2(o[c][4 * j + 2 * h] / den, o[c][4 * j + 2 * h + 1] / den);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------ host side
constexpr int padded(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

long long tile_floats(int bh, int t, int d) {
  return static_cast<long long>(bh) * ((t + kBK - 1) / kBK) * 2 * (padded(d) / 64) * kSlotFloats;
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, float* tiles,
                   int bh, int s, int t, int d, int causal, long long window, cudaStream_t st) {
  using P = Plan<DP>;
  const int n_kt = (t + kBK - 1) / kBK;
  const long long n_slots = static_cast<long long>(bh) * n_kt * 2 * P::kNC;
  const long long n_blocks = static_cast<long long>((s + P::kBQ - 1) / P::kBQ) * bh;
  if (n_slots > 0x7fffffffLL || n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  split_kv<P::kNC><<<static_cast<unsigned>(n_slots), 256, 0, st>>>(k, v, tiles, t, d, n_kt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_tf32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::kSmem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = static_cast<float>(pow(static_cast<double>(d), -0.5) *
                                              1.4426950408889634);
  flash_fwd_tf32<DP><<<static_cast<unsigned>(n_blocks), P::kThreads, P::kSmem, st>>>(
      q, tiles, out, s, t, d, bh, causal, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// fp32 q [bh, s, d], k/v [bh, t, d] -> out [bh, s, d], contiguous; `tiles`
// is the caller's fp32 scratch of `tiles_floats` elements for the split K
// and V^T (bh * ceil(t / 64) * 2 * D' / 64 * 8,192, D' = d rounded up to 64,
// 128 or 256).  d a multiple of 4 up to 256 and every base 16-byte aligned
// (the caller routes the other fp32 inputs to csrc/flash_attn.cu).  causal:
// 0/1; window < 0: no window.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or scratch it does not take.
extern "C" int repro_flash_attention_tf32(void* tiles, long long tiles_floats, const void* q,
                                          const void* k, const void* v, void* out, int bh, int s,
                                          int t, int d, int causal, long long window,
                                          void* stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(tiles);
  if (bh < 1 || s < 1 || t < 1 || d < 4 || d > 256 || d % 4 != 0 || bases % 16 != 0 ||
      tiles_floats != tile_floats(bh, t, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float *fo = static_cast<float*>(out), *ft = static_cast<float*>(tiles);
  if (d <= 64) return static_cast<int>(launch<64>(fq, fk, fv, fo, ft, bh, s, t, d, causal, window, st));
  if (d <= 128) return static_cast<int>(launch<128>(fq, fk, fv, fo, ft, bh, s, t, d, causal, window, st));
  return static_cast<int>(launch<256>(fq, fk, fv, fo, ft, bh, s, t, d, causal, window, st));
}
