// Flash attention (forward) for Hopper (sm_90a).  Replaces the Pallas kernel
// repro/kernels/flash_attn.py::flash_attention (body _kernel): online-softmax
// attention on the head-major layout [BH, S, D], causal and/or sliding-window
// mask, fp32 scores and statistics, output acc / max(l, 1e-30) at the input
// dtype (fp32, or bf16 through uint16 pointers).  Its plain version is
// repro_torch.kernels.flash_attn.flash_attention_plain (the reference's
// kernels/ref.py::mha_ref).
//
// What it computes is the reference kernel's step, per live K tile:
//   s = q.k * scale, masked to -1e30 (keys past T: -inf, so they add nothing);
//   m' = max(m, rowmax s); corr = exp(m - m'); p = exp(s - m');
//   l = l * corr + rowsum p; acc = acc * corr + p.v; m = m'.
// Positions of q and k both count from 0: key j is live for query i when
// j <= i (causal) and j > i - window (window >= 0; the 64-bit width takes
// gemma3's 2^24 "no window").  A K tile the mask leaves wholly dead is
// skipped, as the reference's pl.when(live) does.
//
// Design.  The TPU kernel walks K blocks on a sequential grid axis with m, l
// and acc in VMEM scratch; here one block of 256 threads owns one (bh, 64-row
// query tile) and loops over 64-key tiles itself.  Q (fp32, transposed) stays
// in shared memory for the whole loop; each tile's K (transposed) and V are
// widened to fp32 into shared memory.  Thread (ty, tx) of a 16 x 16 grid owns
// query rows ty + 16 i (i < 4): it computes the 4 x 4 scores of keys
// tx + 16 j, and holds the accumulator of columns tx + 16 c (c < NC, NC =
// ceil(D / 16), so D need not be a multiple of 32) in registers.  Row max and
// row sum reduce over the 16 lanes of a half-warp with an xor butterfly, so
// every lane holds the same m and l bit for bit.  Both products are fp32 FMAs
// on the CUDA cores (fmaf: --fmad=false does not apply to explicit FMAs); p
// stays fp32 in p.v.  The heaviest causal tiles (the last) start first.
//
// Bound: operations.  4 D flops per live (query, key) pair in fp32 against
// reading q, k, v and writing o once.  This first kernel uses no tensor cores
// and no asynchronous copies: loads and products alternate, each tile behind
// a barrier.  Shared memory: (2 D x 65 + 64 x 16 NC + 64 x 80) x 4 bytes,
// 214 KB at D = 256 (one block per SM), so the launch raises the block's
// dynamic shared memory limit.
#include <math.h>
#include <stdint.h>

#include "tree_sum.cuh"  // repro_cuda_error_string

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // a 16 x 16 grid of threads
constexpr int kRows = kBQ / 16;  // rows per thread: ty + 16 i
constexpr int kKeys = kBK / 16;  // keys per thread: tx + 16 j
constexpr int kLdq = kBQ + 1;    // transposed tiles: +1 keeps the stores
constexpr int kLdk = kBK + 1;    // of a warp's 32 columns in 32 banks
constexpr int kLdp = kBK + 16;   // the two half-warps' rows 16 banks apart
constexpr float kNeg = -1e30f;   // the reference's _NEG

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

__device__ __forceinline__ float to_out(float x, const float*) { return x; }
// float -> bfloat16 bits, round to nearest even; NaN -> 0x7fc0 (torch's cast)
__device__ __forceinline__ uint16_t to_out(float x, const uint16_t*) {
  const unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int row0, int n_rows,
                                          int d, int warp, int lane, float* dst, int ld,
                                          bool transpose) {
  for (int r = warp; r < kBK; r += kThreads / 32) {
    const int i = row0 + r;
    for (int c = lane; c < d; c += 32) {
      const float x = i < n_rows ? widen(src[static_cast<long long>(i) * d + c]) : 0.f;
      if (transpose) {
        dst[c * ld + r] = x;
      } else {
        dst[r * ld + c] = x;
      }
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, int s_len, int t_len, int d, int causal,
              long long window, float scale) {
  static_assert(kBQ == kBK, "load_rows walks kBK rows for both tiles");
  constexpr int kLdv = 16 * NC;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [d][kLdq]   Q tile, transposed
  float* ks = qs + d * kLdq;   // [d][kLdk]   K tile, transposed
  float* vs = ks + d * kLdk;   // [kBK][kLdv] V tile, columns >= d stay 0
  float* ps = vs + kBK * kLdv; // [kBQ][kLdp] probabilities

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const long long bh = blockIdx.y;
  const T* qb = q + bh * s_len * d;
  const T* kb = k + bh * t_len * d;
  const T* vb = v + bh * t_len * d;

  for (int i = tid; i < kBK * kLdv; i += kThreads) vs[i] = 0.f;
  load_rows(qb, q0, s_len, d, warp, lane, qs, kLdq, true);

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, s_len) - 1;
  const int n_kt = (t_len + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const int k_last = min(k0 + kBK, t_len) - 1;
    if (causal && k0 > q_last) break;  // this tile and every later one dead
    if (window >= 0 && static_cast<long long>(k_last) <= q0 - window) continue;

    __syncthreads();  // the last tile's reads of ks, vs, ps are done
    load_rows(kb, k0, t_len, d, warp, lane, ks, kLdk, true);
    load_rows(vb, k0, t_len, d, warp, lane, vs, kLdv, false);
    __syncthreads();

    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float a[kRows], b[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[c * kLdq + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) b[j] = ks[c * kLdk + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (col >= t_len) {
          x = -INFINITY;
        } else if ((causal && col > row) ||
                   (window >= 0 && static_cast<long long>(col) <= row - window)) {
          x = kNeg;
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(ty + 16 * i) * kLdp + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(ty + 16 * i) * kLdp + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vj = vs[j * kLdv + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(p[i], vj, acc[i][c]);
      }
    }
  }

  T* ob = out + bh * s_len * d;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[static_cast<long long>(row) * d + col] = to_out(acc[i][c] / den, ob);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int s,
                   int t, int d, int causal, long long window, cudaStream_t st) {
  const size_t smem =
      (static_cast<size_t>(d) * (kLdq + kLdk) + kBK * 16 * NC + kBQ * kLdp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(pow(static_cast<double>(d), -0.5));
  const dim3 grid((s + kBQ - 1) / kBQ, bh);
  flash_fwd<T, NC><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, t, d, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int bh, int s,
                     int t, int d, int causal, long long window, cudaStream_t st) {
  if (d <= 16) return launch<T, 1>(q, k, v, out, bh, s, t, d, causal, window, st);
  if (d <= 32) return launch<T, 2>(q, k, v, out, bh, s, t, d, causal, window, st);
  if (d <= 64) return launch<T, 4>(q, k, v, out, bh, s, t, d, causal, window, st);
  if (d <= 128) return launch<T, 8>(q, k, v, out, bh, s, t, d, causal, window, st);
  return launch<T, 16>(q, k, v, out, bh, s, t, d, causal, window, st);
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (uint16 bits).  q [bh, s, d], k/v [bh, t, d], out
// [bh, s, d], contiguous.  causal: 0/1; window < 0: no window.  Returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not take).
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, int bh, int s, int t, int d, int causal,
                                     long long window, void* stream) {
  if (bh < 1 || bh > 65535 || s < 1 || t < 1 || d < 1 || d > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch<float>(q, k, v, out, bh, s, t, d, causal, window, st));
    case 1:
      return static_cast<int>(dispatch<uint16_t>(q, k, v, out, bh, s, t, d, causal, window, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
