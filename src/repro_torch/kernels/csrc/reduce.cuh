// The deterministic two-level sum shared by the dot and fused-phase kernels.
// It must reproduce, bit for bit, repro_torch.kernels.dot.chunk_tree:
//
//   1. the n leaves are padded with +0 to nb * kChunk and cut into nb chunks
//      of kChunk contiguous leaves; each chunk is reduced by the halving tree
//      of repro_torch.core.batch.tree_sum (leaf j + leaf j + w/2, repeatedly);
//   2. the nb chunk sums are reduced by the same halving tree (padded with +0
//      to the next power of two).
//
// Step 1 runs one block of kRedThreads threads per chunk.  Thread t holds the
// leaves t + k * kRedThreads (k < kRedItems), so the first log2(kRedItems)
// levels of the chunk's tree pair leaves inside a thread (fold_items) and the
// rest pair threads t and t + s (block_tree): the classic stride-halving
// block reduction is exactly the halving tree.  Step 2 is a second launch of
// one block per output (tree_finish).  No floating-point atomics anywhere, so
// the result does not depend on the order in which blocks run.
#pragma once

#include "tree_sum.cuh"

namespace repro {

constexpr int kRedThreads = 256;
constexpr int kRedItems = 8;
constexpr int kChunk = kRedThreads * kRedItems;  // repro_torch.kernels.dot.CHUNK

__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// The index of the leaf this thread holds in slot k of its block's chunk.
__device__ __forceinline__ long long chunk_leaf(int k) {
  return static_cast<long long>(blockIdx.x) * kChunk + threadIdx.x +
         static_cast<long long>(k) * kRedThreads;
}

// The in-thread levels of the chunk tree: slot k + s onto slot k.
template <typename T>
__device__ __forceinline__ T fold_items(T (&v)[kRedItems]) {
#pragma unroll
  for (int s = kRedItems / 2; s > 0; s >>= 1) {
#pragma unroll
    for (int k = 0; k < s; ++k) v[k] = add_rn(v[k], v[k + s]);
  }
  return v[0];
}

// Halving tree over the first `width` threads' values (width a power of two,
// at most kRedThreads); the sum lands in thread 0.  Every thread of the block
// must call it.  `sh` holds kRedThreads values and may be reused by the next
// call: the last shared level ends on a barrier.
template <typename T>
__device__ __forceinline__ T block_tree(T v, int width, T* sh) {
  const int t = threadIdx.x;
  for (int s = width / 2; s >= 32; s >>= 1) {
    sh[t] = v;
    __syncthreads();
    if (t < s) v = add_rn(v, sh[t + s]);
    __syncthreads();
  }
  if (t < 32) {
    for (int s = (width < 32 ? width : 32) / 2; s > 0; s >>= 1)
      v = add_rn(v, __shfl_down_sync(0xffffffffu, v, s));
  }
  return v;
}

// Step 2: block b reduces part[b * nb .. b * nb + nb) into out[b].
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
    tree_finish(const T* __restrict__ part, int nb, T* __restrict__ out) {
  __shared__ T sh[kRedThreads];
  const T* p = part + static_cast<long long>(blockIdx.x) * nb;
  int logw = 0;
  while ((1 << logw) < nb) ++logw;
  const int wp = 1 << logw;
  const int t = threadIdx.x;
  T v = T(0);
  if (wp >= kRedThreads) {
    // leaves t + k * kRedThreads: the top levels of the tree stay in-thread
    v = tree_sum<T>(wp / kRedThreads, [&](int k) {
      const int j = t + k * kRedThreads;
      return j < nb ? p[j] : T(0);
    });
  } else if (t < nb) {
    v = p[t];
  }
  v = block_tree(v, wp < kRedThreads ? wp : kRedThreads, sh);
  if (t == 0) out[blockIdx.x] = v;
}

inline int chunks(long long n) {
  const long long nb = (n + kChunk - 1) / kChunk;
  return nb < 1 ? 1 : static_cast<int>(nb);
}

}  // namespace repro
