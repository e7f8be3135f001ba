// Fused JPCG phases 2 and 3 for Hopper (sm_90a).  Replaces the Pallas kernels
// repro/kernels/fused_phase.py::phase2_pallas and ::phase3_pallas.
//
//   phase 2: r' = r - alpha * ap (M4), written once; z = r' / M (M5) stays in
//            a register and never reaches memory; [r'.r', r'.z] (M8, M6) by
//            the chunk tree of reduce.cuh, so the two scalars equal
//            repro_torch.kernels.fused_phase.phase2_plain bit for bit.
//   phase 3: z = r' / M recomputed (paper 5.3), p' = z + beta * p (M7),
//            x' = x + alpha * p (M3); p is read once for both outputs.
//
// alpha and beta are read through device pointers, so the solve loop never
// copies them to the host.  The TPU kernels pad every vector to a whole tile
// and pad M with ones; here each thread checks its index against n instead.
// Every product, quotient and sum is correctly rounded (the _rn intrinsics,
// --fmad=false): r - alpha * ap and z + beta * p are never contracted.
//
// Bound: bytes.  Phase 2 reads r, ap, M and writes r' (3R + 1W vectors, the
// chunk sums are 1/2048 of that); phase 3 reads r', M, p, x and writes p', x'
// (4R + 2W).  A handful of flops per element against 8 or 12 B of fp64
// traffic per vector.
#include "reduce.cuh"

namespace {

using repro::chunk_leaf;
using repro::kRedItems;
using repro::kRedThreads;

template <typename T>
__global__ void __launch_bounds__(kRedThreads)
    phase2_chunks(const T* __restrict__ alpha_p, const T* __restrict__ r,
                  const T* __restrict__ ap, const T* __restrict__ m,
                  T* __restrict__ r_new, long long n, int nb, T* __restrict__ part) {
  __shared__ T sh[kRedThreads];
  const T alpha = *alpha_p;
  T rr[kRedItems], rz[kRedItems];
#pragma unroll
  for (int k = 0; k < kRedItems; ++k) {
    const long long j = chunk_leaf(k);
    if (j < n) {
      const T rn = repro::sub_rn(r[j], repro::mul_rn(alpha, ap[j]));
      r_new[j] = rn;
      const T z = repro::div_rn(rn, m[j]);
      rr[k] = repro::mul_rn(rn, rn);
      rz[k] = repro::mul_rn(rn, z);
    } else {
      rr[k] = rz[k] = T(0);
    }
  }
  const T s0 = repro::block_tree(repro::fold_items(rr), kRedThreads, sh);
  const T s1 = repro::block_tree(repro::fold_items(rz), kRedThreads, sh);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s0;
    part[nb + blockIdx.x] = s1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kRedThreads)
    phase3_kernel(const T* __restrict__ alpha_p, const T* __restrict__ beta_p,
                  const T* __restrict__ r_new, const T* __restrict__ m,
                  const T* __restrict__ p, const T* __restrict__ x,
                  T* __restrict__ p_new, T* __restrict__ x_new, long long n) {
  const T alpha = *alpha_p;
  const T beta = *beta_p;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    const T pj = p[j];
    const T z = repro::div_rn(r_new[j], m[j]);
    p_new[j] = repro::add_rn(z, repro::mul_rn(beta, pj));
    x_new[j] = repro::add_rn(x[j], repro::mul_rn(alpha, pj));
  }
}

template <typename T>
cudaError_t launch_phase2(const void* alpha, const void* r, const void* ap, const void* m,
                          void* r_new, long long n, void* part, void* out,
                          cudaStream_t s) {
  const int nb = repro::chunks(n);
  phase2_chunks<T><<<nb, kRedThreads, 0, s>>>(
      static_cast<const T*>(alpha), static_cast<const T*>(r), static_cast<const T*>(ap),
      static_cast<const T*>(m), static_cast<T*>(r_new), n, nb, static_cast<T*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  repro::tree_finish<T><<<2, kRedThreads, 0, s>>>(static_cast<const T*>(part), nb,
                                                  static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_phase3(const void* alpha, const void* beta, const void* r_new,
                          const void* m, const void* p, const void* x, void* p_new,
                          void* x_new, long long n, cudaStream_t s) {
  if (n == 0) return cudaSuccess;
  const long long want = (n + kRedThreads - 1) / kRedThreads;
  const int blocks = want < (1 << 30) ? static_cast<int>(want) : (1 << 30);
  phase3_kernel<T><<<blocks, kRedThreads, 0, s>>>(
      static_cast<const T*>(alpha), static_cast<const T*>(beta),
      static_cast<const T*>(r_new), static_cast<const T*>(m), static_cast<const T*>(p),
      static_cast<const T*>(x), static_cast<T*>(p_new), static_cast<T*>(x_new), n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp64, 1 fp32.  alpha, beta: one value each on the device.
// Vectors [n]; `part` holds 2 * chunks(n) values (the wrapper sizes it),
// `out` gets [r'.r', r'.z].  Both return cudaGetLastError().
extern "C" int repro_phase2(int dtype, const void* alpha, const void* r, const void* ap,
                            const void* m, void* r_new, long long n, void* part,
                            void* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_phase2<double>(alpha, r, ap, m, r_new, n, part, out, s));
    case 1:
      return static_cast<int>(launch_phase2<float>(alpha, r, ap, m, r_new, n, part, out, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int repro_phase3(int dtype, const void* alpha, const void* beta,
                            const void* r_new, const void* m, const void* p, const void* x,
                            void* p_new, void* x_new, long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_phase3<double>(alpha, beta, r_new, m, p, x, p_new, x_new, n, s));
    case 1:
      return static_cast<int>(
          launch_phase3<float>(alpha, beta, r_new, m, p, x, p_new, x_new, n, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
