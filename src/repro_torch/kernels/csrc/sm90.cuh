// Hopper (sm_90a) machinery shared by the two wgmma flash-attention kernels,
// csrc/flash_attn_sm90.cu (bf16) and csrc/flash_attn_tf32.cu (fp32 as three
// TF32 products): mbarriers and their waits, the consumers' named barriers,
// TMA and bulk copies, wgmma's fences, shared-memory matrix descriptors with
// the 128-byte swizzle, the base-2 exponential, and the online softmax of one
// 64 x 64 score tile held in a wgmma accumulator.  Everything here is inlined
// where it is used, so each kernel compiles as if it were written in place.
#pragma once

#include <cuda.h>  // CUtensorMap
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

constexpr float kNeg = -1e30f;     // the reference's _NEG
constexpr int kRowBytes = 128;     // a tile row in shared memory (one swizzle row)
constexpr int kSmemLimit = 232448; // a block's shared memory on the H100

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ barriers
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the completion of the phase of `bar` with parity `parity`.  A wait
// that outlasts 2^33 clocks (seconds: only a fault can take that long) traps,
// so the launch ends with an error instead of hanging the card.  The loop is
// PTX: written in C++ around clock64(), it leaves ptxas unable to keep the
// wgmma pipelines' registers (it spills and serializes them).
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t.reg .u64 t0, t;\n\t"
      "mov.u64 t0, %%clock64;\n"
      "WAIT_%=:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE_%=;\n\t"
      "mov.u64 t, %%clock64;\n\t"
      "sub.u64 t, t, t0;\n\t"
      "setp.lt.u64 p, t, 0x200000000;\n\t"
      "@p bra WAIT_%=;\n\t"
      "trap;\n"
      "DONE_%=:\n\t}" ::"r"(bar), "r"(parity)
      : "memory");
}

// The consumers' turns: named barriers 1 and 2, each met by the 256 threads
// of both consumer warpgroups (one waits, the other arrives).
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// A 64 x 64 box of the 3-D map at (column c0, row c1, head c2) into shared
// memory at dst, completing on bar.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) from global src (16-byte aligned) into shared
// memory at dst as one bulk copy, completing on bar.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, unsigned bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------ wgmma
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Registers an asynchronous wgmma reads or writes stay where they are, and
// are not read early, until the wait before this.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// A shared-memory matrix descriptor with the 128-byte swizzle: the start
// address, the leading and the stride byte offsets (16-byte units).
// K-major: 8-row groups 1,024 bytes apart (stride), the leading offset
// unused.  MN-major (the bf16 kernel's V): 8-row groups of keys 1,024 bytes
// apart (stride), 64-column chunks `lead` bytes apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) | (static_cast<uint64_t>(stride >> 4) << 32) |
         (1ull << 62);
}

// desc + offset bytes, computed where the wgmma that takes it is issued (the
// compiler would otherwise hold every step's descriptor of a tile in
// registers): the start address is the low field, and no tile crosses
// 256 KB, so the sum stays in it
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t offset) {
  uint64_t r;
  asm volatile("add.s64 %0, %1, %2;" : "=l"(r) : "l"(d), "l"(static_cast<uint64_t>(offset >> 4)));
  return r;
}

// ------------------------------------------------------------ arithmetic
// 2^x: MUFU.EX2 (ex2.approx.f32, denormals kept)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// What a consumer thread needs to mask its scores: score register i holds
// row row0 + 8 ((i / 2) % 2), key k0 + 8 (i / 4) + 2 t4 + i % 2.
struct Mask {
  int t_len, causal;
  long long window;
  int wq0, row0, t4;
  float scale_log2;
};

// x = the scaled score; on a tile that crosses T, the diagonal or the
// window's edge (kEdge), masked to -inf (keys past T) or -1e30 (the rest of
// the mask) by selects, so the tile's elements run without branches
template <bool kEdge, int NS>
__device__ __forceinline__ void scale_mask(float (&sc)[NS], int k0, const Mask& mk) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float x = sc[i] * mk.scale_log2;
    if constexpr (kEdge) {
      const int row = mk.row0 + 8 * ((i >> 1) & 1);
      const int col = k0 + 8 * (i >> 2) + 2 * mk.t4 + (i & 1);
      const bool dead = (mk.causal && col > row) ||
                        (mk.window >= 0 && static_cast<long long>(col) <= row - mk.window);
      x = col >= mk.t_len ? -INFINITY : dead ? kNeg : x;
    }
    sc[i] = x;
  }
}

// One tile of the online softmax in base 2: sc (raw scores of keys k0 ..)
// becomes p = 2^(x - m'), x the scaled and masked scores (scale_mask) for
// the warpgroup's rows; m becomes m', l becomes l corr + rowsum p,
// corr = 2^(m - m').  The mask is decided once a tile.
template <int NS>
__device__ __forceinline__ void online_softmax(float (&sc)[NS], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], int k0, const Mask& mk) {
  constexpr int BK = 2 * NS;
  const int wq_last = mk.wq0 + 63;
  const bool edge = k0 + BK > mk.t_len || (mk.causal && k0 + BK - 1 > mk.wq0) ||
                    (mk.window >= 0 && static_cast<long long>(k0) <= wq_last - mk.window);
  if (edge) {
    scale_mask<true>(sc, k0, mk);
  } else {
    scale_mask<false>(sc, k0, mk);
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    corr[h] = ex2(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float p = ex2(sc[i] - m[(i >> 1) & 1]);
    sc[i] = p;
    l[(i >> 1) & 1] += p;
  }
}

}  // namespace sm90
