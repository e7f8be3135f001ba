// Correctly rounded arithmetic and the fixed-bracketing tree sum shared by
// the SpMV kernels.  Everything here must reproduce, bit for bit, the plain
// PyTorch versions in repro_torch/kernels/spmv.py:
//   * products and sums use the _rn intrinsics (and the sources build with
//     --fmad=false), so no multiply feeding an add is contracted into an FMA;
//   * tree_sum is repro_torch.core.batch.tree_sum: the leaves are padded
//     with +0 to the next power of two wp, then leaf j is added to leaf
//     j + wp/2, repeatedly.  fold is the same tree over a register array
//     whose width is known at compile time.
#pragma once

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

// lv[j] += lv[j + h] for h = H, H / 2, .., 1: tree_sum's bracketing over
// the WP = 2H leaves of lv, unrolled, so lv stays in registers.
template <int H, int WP, typename ACC>
__device__ __forceinline__ void fold(ACC (&lv)[WP]) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int j = 0; j < H; ++j) lv[j] = add_rn(lv[j], lv[j + H]);
    fold<H / 2, WP>(lv);
  }
}

// Deepest stack tree_sum needs: log2(wp) + 1 entries, wp < 2^31.
constexpr int kTreeDepth = 32;

// Halving-tree sum of leaf(0) .. leaf(w - 1) for a width known only at run
// time.  The halving fold pairs leaves that differ in the highest index bit
// first, so visiting the leaves in bit-reversed order makes it a plain
// pairwise tree over adjacent leaves, which a binary-counter stack of
// log2(wp) + 1 partial sums evaluates in one pass: after the k-th leaf, the
// stack merges once per trailing one bit of k.  The stack is indexed at run
// time, so it lives in local memory (fold keeps a fixed width in registers).
template <typename ACC, typename Leaf>
__device__ __forceinline__ ACC tree_sum(int w, Leaf leaf) {
  if (w <= 0) return ACC(0);
  int logw = 0;
  while ((1 << logw) < w) ++logw;
  const int wp = 1 << logw;
  ACC stk[kTreeDepth];
  int sp = 0;
  for (int k = 0; k < wp; ++k) {
    const int j = logw ? static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - logw)) : 0;
    ACC v = j < w ? leaf(j) : ACC(0);
    for (unsigned m = static_cast<unsigned>(k) + 1u; (m & 1u) == 0u; m >>= 1) {
      v = add_rn(stk[--sp], v);
    }
    stk[sp++] = v;
  }
  return stk[0];
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
