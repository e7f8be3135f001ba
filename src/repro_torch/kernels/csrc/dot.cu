// Deterministic dot products for Hopper (sm_90a).  Replaces the Pallas kernels
// repro/kernels/dot.py::dot_pallas (<a, b>, the M2 module p.ap of the
// single-system loop) and ::dot3_pallas ([r.u, w.u, r.r] of pipelined CG).
//
// The TPU kernels keep an [8, 512] tile of lane partial sums in VMEM across a
// sequential grid and tree-reduce it on the last step.  Hopper runs blocks in
// no order, so the sum is the two-level chunk tree of reduce.cuh: each
// 2048-leaf chunk's sum is written to `part`, and the chunk sums are reduced
// by the same halving tree.  Both kernels finish in one launch: each block
// takes an integer ticket after writing its sums, and the block that draws
// the last ticket reduces the chunk sums (tree_finish's order) and resets the
// counter.  No floating-point atomics, and products are correctly rounded
// (mul_rn, --fmad=false), so the result equals
// repro_torch.kernels.dot.dot_plain / dot3_plain bit for bit.
//
// Bound: bytes.  Each input is read once (16 B per element for fp64 dot,
// 24 B for dot3) against 2 (dot) or 6 (dot3) flops per element; the chunk
// sums are 1/2048 of that.
//
// dot (dot_chunks): one block per chunk; each thread keeps kRedItems
// independent loads per input in flight, neighbouring threads on
// neighbouring addresses.
//
// dot3 (dot3_bulk): one block per chunk too, reading through the Hopper
// copy engine: thread 0 fills the block's stage in dynamic shared memory
// (one chunk of r, u and w) with three 1-D bulk asynchronous copies (TMA
// without a tensor map) that complete on the block's mbarrier, armed with
// their exact bytes, under an evict-first L2 policy.  An H100 SM holds 4 such
// blocks at fp64 (its shared memory) and more at fp32, so the stages of the
// blocks it holds are the ring: copies land in some while others reduce.  A slice that a bulk copy
// cannot take (a global address that is not 16-byte aligned, or a ragged
// last chunk whose bytes are not a multiple of 16) is read with plain loads
// instead, chosen per vector and chunk inside the kernel; leaves past n read
// as +0.  The three sums share one block tree (block_tree3: block_tree's
// bracketing, one barrier pair per shared level for all three), and the last
// block's finish keeps eight loads of part in flight a thread (tree_sum8).
// A persistent grid walking the chunks through a ring of 4 stages per block
// was slower on an H100 (0.101 against 0.089 ms at n = 10^7, fp64).
#include <cstdint>

#include "reduce.cuh"

namespace {

using repro::add_rn;
using repro::chunk_leaf;
using repro::kChunk;
using repro::kRedItems;
using repro::kRedThreads;
using repro::mul_rn;

// tree_finish's halving tree over the nb chunk sums part[0 .. nb), run by
// one whole block; the sum lands in thread 0.  The sums were written by
// other blocks of this launch, so they are read from L2 (__ldcg), never
// from a stale L1 line.
template <typename T>
__device__ __forceinline__ T finish_tree(const T* part, int nb, T* sh) {
  int logw = 0;
  while ((1 << logw) < nb) ++logw;
  const int wp = 1 << logw;
  const int t = threadIdx.x;
  T v = T(0);
  if (wp >= kRedThreads) {
    v = repro::tree_sum<T>(wp / kRedThreads, [&](int k) {
      const int j = t + k * kRedThreads;
      return j < nb ? __ldcg(part + j) : T(0);
    });
  } else if (t < nb) {
    v = __ldcg(part + t);
  }
  return repro::block_tree(v, wp < kRedThreads ? wp : kRedThreads, sh);
}

// One launch: block b writes chunk b's sum, then takes a ticket; the block
// that draws the last one reduces the chunk sums into out and sets the
// counter back to 0 for the next call.
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
    dot_chunks(const T* __restrict__ a, const T* __restrict__ b, long long n,
               T* __restrict__ part, T* __restrict__ out,
               unsigned* __restrict__ ticket) {
  __shared__ T sh[kRedThreads];
  __shared__ bool last;
  T v[kRedItems];
#pragma unroll
  for (int k = 0; k < kRedItems; ++k) {
    const long long j = chunk_leaf(k);
    v[k] = j < n ? repro::mul_rn(a[j], b[j]) : T(0);
  }
  const T s = repro::block_tree(repro::fold_items(v), kRedThreads, sh);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s;
    __threadfence();  // the sum is visible to every block before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  const T total = finish_tree(part, static_cast<int>(gridDim.x), sh);
  if (threadIdx.x == 0) {
    *out = total;
    *ticket = 0u;
  }
}

// ------------------------------------------------------------------ dot3

// dot3_bulk<T>'s dynamic shared memory: the block's stage [3][kChunk], one
// chunk of r, u and w (48 KB at fp64, 24 KB at fp32).
template <typename T>
constexpr int dot3_stage_bytes() {
  return static_cast<int>(3 * kChunk * sizeof(T));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// The one arrival on the barrier, expecting `bytes` of bulk copies to
// complete on it as well (none: a plain arrival).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, unsigned bytes) {
  if (bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
  } else {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
  }
}

// Wait for the completion of the phase of `bar` with parity `parity`.  A wait
// that outlasts 2^33 clocks (seconds; only a byte count that no copy will
// meet can take that long) traps, so such a fault ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  long long start = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    if (now - start > (1LL << 33)) __trap();
  }
}

// A bulk copy takes a 16-byte-aligned global address and a size that is a
// positive multiple of 16 bytes.
__device__ __forceinline__ bool bulk_ok(const void* src, unsigned bytes) {
  return bytes != 0u && bytes % 16u == 0u && reinterpret_cast<uintptr_t>(src) % 16u == 0u;
}

// An L2 policy for the bulk copies: the streamed lines (each read once) are
// evicted first.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// block_tree over three values at once: the same halving bracketing for each
// (threads t and t + s, s from width / 2; shared levels down to 32, shuffles
// below), one barrier pair per shared level for all three.  The sums land in
// thread 0; `sh` holds 3 * kRedThreads values and may be reused once this
// returns (the last shared level ends on a barrier).
template <typename T>
__device__ __forceinline__ void block_tree3(T (&v)[3], int width, T* sh) {
  const int t = threadIdx.x;
  for (int s = width / 2; s >= 32; s >>= 1) {
#pragma unroll
    for (int q = 0; q < 3; ++q) sh[q * kRedThreads + t] = v[q];
    __syncthreads();
    if (t < s) {
#pragma unroll
      for (int q = 0; q < 3; ++q) v[q] = add_rn(v[q], sh[q * kRedThreads + t + s]);
    }
    __syncthreads();
  }
  if (t < 32) {
    for (int s = (width < 32 ? width : 32) / 2; s > 0; s >>= 1) {
#pragma unroll
      for (int q = 0; q < 3; ++q) v[q] = add_rn(v[q], __shfl_down_sync(0xffffffffu, v[q], s));
    }
  }
}

// repro::tree_sum over wp leaves (a power of two, at least 8) with eight
// loads in flight: tree_sum visits the leaves in bit-reversed order and adds
// neighbours in that order, so each aligned run of eight visits is a whole
// subtree.  Its eight leaves are loaded together, added in the subtree's
// bracketing, and the subtree's sum enters tree_sum's stack as one leaf.
template <typename T, typename Leaf>
__device__ __forceinline__ T tree_sum8(int wp, Leaf leaf) {
  int logw = 0;
  while ((1 << logw) < wp) ++logw;
  T stk[repro::kTreeDepth];
  int sp = 0;
  for (int g = 0; g < wp / 8; ++g) {
    T l[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      l[e] = leaf(static_cast<int>(__brev(static_cast<unsigned>(8 * g + e)) >> (32 - logw)));
    }
    T v = add_rn(add_rn(add_rn(l[0], l[1]), add_rn(l[2], l[3])),
                 add_rn(add_rn(l[4], l[5]), add_rn(l[6], l[7])));
    for (unsigned m = static_cast<unsigned>(g) + 1u; (m & 1u) == 0u; m >>= 1) {
      v = add_rn(stk[--sp], v);
    }
    stk[sp++] = v;
  }
  return stk[0];
}

// tree_finish's order over the three rows of part [3, nb], run by the block
// that drew the last ticket; the sums go to out[0 .. 3).  Thread t's leaves
// are t + kRedThreads * k; from eight of them a thread up, tree_sum8 keeps
// eight loads in flight (tree_sum's one at a time cost about 15 us at n = 10^7
// on an H100).
// part is read from L2 (__ldcg), never from a stale L1 line.
template <typename T>
__device__ __forceinline__ void finish3(const T* part, int nb, T* sh, T* out) {
  int logw = 0;
  while ((1 << logw) < nb) ++logw;
  const int wp = 1 << logw;
  const int t = threadIdx.x;
  const int per = wp / kRedThreads;  // leaves a thread (0: one or none)
  T v[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    auto leaf = [&](int k) -> T {
      const int j = t + k * kRedThreads;
      return j < nb ? __ldcg(part + q * nb + j) : T(0);
    };
    if (per >= 8) {
      v[q] = tree_sum8<T>(per, leaf);
    } else if (per >= 1) {
      v[q] = repro::tree_sum<T>(per, leaf);
    } else {
      v[q] = leaf(0);
    }
  }
  block_tree3(v, wp < kRedThreads ? wp : kRedThreads, sh);
  if (t == 0) {
    out[0] = v[0];
    out[1] = v[1];
    out[2] = v[2];
  }
}

// One launch, one block per chunk (as dot): thread 0 arms the block's
// mbarrier with the bytes of the chunk's bulk copies and issues them into the
// stage; the slices no copy may take are loaded plainly meanwhile.  The
// block's chunk sums go to part[q * nb + c] (q = r.u, w.u, r.r); then a
// ticket, and the block that draws the last one runs finish3 and sets the
// counter back to 0 for the next call.
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
    dot3_bulk(const T* __restrict__ r, const T* __restrict__ u, const T* __restrict__ w,
              long long n, T* __restrict__ part, T* __restrict__ out,
              unsigned* __restrict__ ticket) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);  // [3][kChunk]
  __shared__ __align__(8) uint64_t full;
  __shared__ T sh[3 * kRedThreads];
  __shared__ bool last;
  const T* vec[3] = {r, u, w};
  const int t = threadIdx.x;
  const int nb = static_cast<int>(gridDim.x);
  const long long j0 = static_cast<long long>(blockIdx.x) * kChunk;
  const int len = static_cast<int>(n - j0 < kChunk ? n - j0 : kChunk);
  const unsigned bytes = static_cast<unsigned>(len) * sizeof(T);
  bool bulk[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) bulk[q] = bulk_ok(vec[q] + j0, bytes);
  if (t == 0) {
    mbar_init(&full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const uint64_t policy = evict_first();
    unsigned tx = 0;
#pragma unroll
    for (int q = 0; q < 3; ++q) tx += bulk[q] ? bytes : 0u;
    mbar_arrive(&full, tx);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (bulk[q]) bulk_copy(stage + q * kChunk, vec[q] + j0, bytes, &full, policy);
    }
  }
  // leaf t + k * kRedThreads of each vector in slot k, +0 past n
  T x[3][kRedItems];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (!bulk[q]) {
#pragma unroll
      for (int k = 0; k < kRedItems; ++k) {
        const int l = t + k * kRedThreads;
        x[q][k] = l < len ? vec[q][j0 + l] : T(0);
      }
    }
  }
  __syncthreads();  // the barrier is initialised before any thread waits on it
  mbar_wait(&full, 0);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (bulk[q]) {
#pragma unroll
      for (int k = 0; k < kRedItems; ++k) {
        const int l = t + k * kRedThreads;
        x[q][k] = l < len ? stage[q * kChunk + l] : T(0);
      }
    }
  }
  T v[3], p[kRedItems];
#pragma unroll
  for (int k = 0; k < kRedItems; ++k) p[k] = mul_rn(x[0][k], x[1][k]);
  v[0] = repro::fold_items(p);
#pragma unroll
  for (int k = 0; k < kRedItems; ++k) p[k] = mul_rn(x[2][k], x[1][k]);
  v[1] = repro::fold_items(p);
#pragma unroll
  for (int k = 0; k < kRedItems; ++k) p[k] = mul_rn(x[0][k], x[0][k]);
  v[2] = repro::fold_items(p);
  block_tree3(v, kRedThreads, sh);
  if (t == 0) {
    part[blockIdx.x] = v[0];
    part[nb + blockIdx.x] = v[1];
    part[2 * nb + blockIdx.x] = v[2];
    __threadfence();  // the sums are visible to every block before the ticket
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(nb) - 1u;
  }
  __syncthreads();
  if (!last) return;
  finish3(part, nb, sh, out);
  if (t == 0) *ticket = 0u;
}

template <typename T>
cudaError_t launch_dot(const void* a, const void* b, long long n, void* part,
                       void* out, void* ticket, cudaStream_t s) {
  const int nb = repro::chunks(n);
  dot_chunks<T><<<nb, kRedThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), n, static_cast<T*>(part),
      static_cast<T*>(out), static_cast<unsigned*>(ticket));
  return cudaGetLastError();
}

// Lets dot3_bulk<T> take its stage beside its static shared memory (over
// the 48 KB default), once per device.
template <typename T>
cudaError_t allow_stage() {
  static unsigned long long done = 0;  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(dot3_bulk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dot3_stage_bytes<T>());
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <typename T>
cudaError_t launch_dot3(const void* r, const void* u, const void* w, long long n, void* part,
                        void* out, void* ticket, cudaStream_t s) {
  const cudaError_t err = allow_stage<T>();
  if (err != cudaSuccess) return err;
  dot3_bulk<T><<<repro::chunks(n), kRedThreads, dot3_stage_bytes<T>(), s>>>(
      static_cast<const T*>(r), static_cast<const T*>(u), static_cast<const T*>(w), n,
      static_cast<T*>(part), static_cast<T*>(out), static_cast<unsigned*>(ticket));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp64, 1 fp32.  Vectors [n]; `part` holds chunks(n) values per
// output (the wrapper sizes it), `out` one value per output.  `ticket` is one
// unsigned counter that is 0 between calls (the wrapper keeps one per device
// and stream; each call leaves it at 0).  Return cudaGetLastError().
extern "C" int repro_dot(int dtype, const void* a, const void* b, long long n, void* part,
                         void* out, void* ticket, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_dot<double>(a, b, n, part, out, ticket, s));
    case 1:
      return static_cast<int>(launch_dot<float>(a, b, n, part, out, ticket, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int repro_dot3(int dtype, const void* r, const void* u, const void* w, long long n,
                          void* part, void* out, void* ticket, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_dot3<double>(r, u, w, n, part, out, ticket, s));
    case 1:
      return static_cast<int>(launch_dot3<float>(r, u, w, n, part, out, ticket, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
