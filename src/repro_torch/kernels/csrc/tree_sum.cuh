// Correctly rounded arithmetic and the fixed-bracketing tree sum shared by
// the SpMV kernels.  Everything here must reproduce, bit for bit, the plain
// PyTorch versions in repro_torch/kernels/spmv.py:
//   * products and sums use the _rn intrinsics (and the sources build with
//     --fmad=false), so no multiply feeding an add is contracted into an FMA;
//   * tree_sum is repro_torch.core.batch.tree_sum: the leaves are padded
//     with +0 to the next power of two wp, then leaf j is added to leaf
//     j + wp/2, repeatedly.  fold is the same tree over a register array
//     whose width is known at compile time.
// At a bf16 accumulator (the TPU tier's tpu_v1) each product and each sum
// rounds to bf16, as eager PyTorch's bf16 ops do: the exact operation at
// fp32, then one round-to-nearest-even to bf16.  A product of two bf16 is
// exact in fp32; a sum rounded twice (to fp32, then to bf16) is still
// correctly rounded, since fp32's 24 bits >= 2 * 8 + 2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ bf16 mul_rn(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ bf16 add_rn(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

// +0 of a value type (bf16 has no constructor from an int to rely on).
template <typename T>
__device__ __forceinline__ T zero() {
  return T(0);
}
template <>
__device__ __forceinline__ bf16 zero<bf16>() {
  return __ushort_as_bfloat16(static_cast<unsigned short>(0));
}

// A value widened to the accumulator's type: exact for every pair the
// kernels instantiate (f32 -> f64, bf16 -> f32, or the same type).
template <typename To, typename From>
__device__ __forceinline__ To widen(From v) {
  return static_cast<To>(v);
}
template <>
__device__ __forceinline__ float widen<float, bf16>(bf16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ bf16 widen<bf16, bf16>(bf16 v) {
  return v;
}

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
  if (w <= 0) return zero<ACC>();
  int logw = 0;
  while ((1 << logw) < w) ++logw;
  const int wp = 1 << logw;
  ACC stk[kTreeDepth];
  int sp = 0;
  for (int k = 0; k < wp; ++k) {
    const int j = logw ? static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - logw)) : 0;
    ACC v = j < w ? leaf(j) : zero<ACC>();
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
