// Deterministic dot products for Hopper (sm_90a).  Replaces the Pallas kernels
// repro/kernels/dot.py::dot_pallas (<a, b>, the M2 module p.ap of the
// single-system loop) and ::dot3_pallas ([r.u, w.u, r.r] of pipelined CG).
//
// The TPU kernels keep an [8, 512] tile of lane partial sums in VMEM across a
// sequential grid and tree-reduce it on the last step.  Hopper runs blocks in
// no order, so the sum is the two-level chunk tree of reduce.cuh: one block
// per 2048-leaf chunk writes its chunk's sum, and the chunk sums are reduced
// by the same halving tree.  dot does that in one launch: each block takes an
// integer ticket after writing its sum, and the block that draws the last
// ticket reduces the chunk sums (tree_finish's order) and resets the counter.
// dot3 keeps a second launch (tree_finish).  No floating-point atomics, and
// products are correctly rounded (mul_rn, --fmad=false), so the result
// equals repro_torch.kernels.dot.dot_plain / dot3_plain bit for bit.
//
// Bound: bytes.  Each input is read once (16 B per element for fp64 dot,
// 24 B for dot3) against 2 (dot) or 6 (dot3) flops per element; the chunk
// sums are 1/2048 of that.  Each thread keeps kRedItems independent loads per
// input in flight, neighbouring threads on neighbouring addresses.
#include "reduce.cuh"

namespace {

using repro::chunk_leaf;
using repro::kRedItems;
using repro::kRedThreads;

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

template <typename T>
__global__ void __launch_bounds__(kRedThreads)
    dot3_chunks(const T* __restrict__ r, const T* __restrict__ u,
                const T* __restrict__ w, long long n, int nb,
                T* __restrict__ part) {
  __shared__ T sh[kRedThreads];
  T ru[kRedItems], wu[kRedItems], rr[kRedItems];
#pragma unroll
  for (int k = 0; k < kRedItems; ++k) {
    const long long j = chunk_leaf(k);
    if (j < n) {
      const T rj = r[j], uj = u[j];
      ru[k] = repro::mul_rn(rj, uj);
      wu[k] = repro::mul_rn(w[j], uj);
      rr[k] = repro::mul_rn(rj, rj);
    } else {
      ru[k] = wu[k] = rr[k] = T(0);
    }
  }
  const T s0 = repro::block_tree(repro::fold_items(ru), kRedThreads, sh);
  const T s1 = repro::block_tree(repro::fold_items(wu), kRedThreads, sh);
  const T s2 = repro::block_tree(repro::fold_items(rr), kRedThreads, sh);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s0;
    part[nb + blockIdx.x] = s1;
    part[2 * nb + blockIdx.x] = s2;
  }
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

template <typename T>
cudaError_t launch_dot3(const void* r, const void* u, const void* w, long long n,
                        void* part, void* out, cudaStream_t s) {
  const int nb = repro::chunks(n);
  dot3_chunks<T><<<nb, kRedThreads, 0, s>>>(
      static_cast<const T*>(r), static_cast<const T*>(u), static_cast<const T*>(w), n,
      nb, static_cast<T*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  repro::tree_finish<T><<<3, kRedThreads, 0, s>>>(static_cast<const T*>(part), nb,
                                                  static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp64, 1 fp32.  Vectors [n]; `part` holds chunks(n) values per
// output (the wrapper sizes it), `out` one value per output.  dot's `ticket`
// is one unsigned counter that is 0 between calls (the wrapper keeps one per
// device and stream; each call leaves it at 0).  Returns cudaGetLastError().
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
                          void* part, void* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_dot3<double>(r, u, w, n, part, out, s));
    case 1:
      return static_cast<int>(launch_dot3<float>(r, u, w, n, part, out, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
