// Designs of dot3 beside the one in src/repro_torch/kernels/csrc/dot.cu, for
// tools/dot3_variants.py to time on the card.  None of them is part of the
// port.  Each computes dot3_plain's bits; they differ in how the leaves are
// read, how the grid walks the chunks and how the chunk sums are finished.
//
//   two_launch<T>    the port's dot3 before its redesign: one block per chunk,
//                    plain loads, three block trees, then tree_finish in a
//                    second launch of 3 blocks
//   ring<T>          a persistent grid (as many blocks as the SMs hold), block
//                    b walking chunks b, b + G, ... through a ring of kStages
//                    stages of bulk copies; chunk sums staged in the ring for
//                    the finish
//   one<T, Bulk, Finish>  one block per chunk: bulk copies (Bulk) or plain
//                    loads; Finish 0: a ticket and finish3 with tree_sum's
//                    one load at a time, 1: a ticket and dot.cu's finish3
//                    (tree_sum8), 2: no ticket, tree_finish in a second launch
//
// Build: nvcc with the flags of repro_torch/kernels/_build.py and
// -I src/repro_torch/kernels/csrc.
#include "dot.cu"

namespace {

constexpr int kStages = 4;

template <typename T>
__global__ void __launch_bounds__(kRedThreads)
    two_launch(const T* __restrict__ r, const T* __restrict__ u, const T* __restrict__ w,
               long long n, int nb, T* __restrict__ part) {
  __shared__ T sh[kRedThreads];
  T ru[kRedItems], wu[kRedItems], rr[kRedItems];
#pragma unroll
  for (int k = 0; k < kRedItems; ++k) {
    const long long j = chunk_leaf(k);
    if (j < n) {
      const T rj = r[j], uj = u[j];
      ru[k] = mul_rn(rj, uj);
      wu[k] = mul_rn(w[j], uj);
      rr[k] = mul_rn(rj, rj);
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

// finish3 with tree_sum's one load at a time (or, with `staged`, after
// copying the rows into shared memory with every load in flight)
template <typename T>
__device__ void finish3_serial(const T* part, int nb, T* buf, bool staged, T* sh, T* out) {
  int logw = 0;
  while ((1 << logw) < nb) ++logw;
  const int wp = 1 << logw;
  const int t = threadIdx.x;
  if (staged) {
    for (int j = t; j < 3 * wp; j += kRedThreads) {
      const int col = j & (wp - 1);
      buf[j] = col < nb ? __ldcg(part + (j >> logw) * nb + col) : T(0);
    }
    __syncthreads();
  }
  T v[3];
  for (int q = 0; q < 3; ++q) {
    auto leaf = [&](int j) -> T {
      if (staged) return buf[q * wp + j];
      return j < nb ? __ldcg(part + q * nb + j) : T(0);
    };
    if (wp >= kRedThreads) {
      v[q] = repro::tree_sum<T>(wp / kRedThreads, [&](int k) { return leaf(t + k * kRedThreads); });
    } else {
      v[q] = t < nb ? leaf(t) : T(0);
    }
  }
  block_tree3(v, wp < kRedThreads ? wp : kRedThreads, sh);
  if (t == 0) {
    out[0] = v[0];
    out[1] = v[1];
    out[2] = v[2];
  }
}

template <typename T>
__device__ __forceinline__ void reduce3(T (&x)[3][kRedItems], T* sh, T (&v)[3]) {
  T p[kRedItems];
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
}

template <typename T, bool Bulk, int Finish>
__global__ void __launch_bounds__(kRedThreads)
    one(const T* __restrict__ r, const T* __restrict__ u, const T* __restrict__ w, long long n,
        T* __restrict__ part, T* __restrict__ out, unsigned* __restrict__ ticket) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
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
  for (int q = 0; q < 3; ++q) bulk[q] = Bulk && bulk_ok(vec[q] + j0, bytes);
  if (Bulk && t == 0) {
    mbar_init(&full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const uint64_t policy = evict_first();
    unsigned tx = 0;
    for (int q = 0; q < 3; ++q) tx += bulk[q] ? bytes : 0u;
    mbar_arrive(&full, tx);
    for (int q = 0; q < 3; ++q) {
      if (bulk[q]) bulk_copy(stage + q * kChunk, vec[q] + j0, bytes, &full, policy);
    }
  }
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
  if (Bulk) {
    __syncthreads();
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
  }
  T v[3];
  reduce3(x, sh, v);
  if (t == 0) {
    part[blockIdx.x] = v[0];
    part[nb + blockIdx.x] = v[1];
    part[2 * nb + blockIdx.x] = v[2];
  }
  if (Finish == 2) return;
  if (t == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(nb) - 1u;
  }
  __syncthreads();
  if (!last) return;
  if (Finish == 1) {
    finish3(part, nb, sh, out);
  } else {
    finish3_serial(part, nb, stage, false, sh, out);
  }
  if (t == 0) *ticket = 0u;
}

template <typename T>
__global__ void __launch_bounds__(kRedThreads)
    ring(const T* __restrict__ r, const T* __restrict__ u, const T* __restrict__ w, long long n,
         int nb, T* __restrict__ part, T* __restrict__ out, unsigned* __restrict__ ticket) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);  // [kStages][3][kChunk]
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ T sh[3 * kRedThreads];
  __shared__ bool last;
  const T* vec[3] = {r, u, w};
  const int t = threadIdx.x;
  const int grid = static_cast<int>(gridDim.x);
  const int b = static_cast<int>(blockIdx.x);
  const int m = nb > b ? (nb - b + grid - 1) / grid : 0;  // this block's chunks
  auto first = [&](int i) { return (static_cast<long long>(b) + static_cast<long long>(i) * grid) * kChunk; };
  auto leaves = [&](long long j0) {
    const long long left = n - j0;
    return static_cast<int>(left < 0 ? 0 : left < kChunk ? left : kChunk);
  };
  const uint64_t policy = evict_first();
  auto fill = [&](int i) {
    const long long j0 = first(i);
    const unsigned bytes = static_cast<unsigned>(leaves(j0)) * sizeof(T);
    T* st = buf + (i % kStages) * 3 * kChunk;
    unsigned tx = 0;
    for (int q = 0; q < 3; ++q) tx += bulk_ok(vec[q] + j0, bytes) ? bytes : 0u;
    mbar_arrive(full + i % kStages, tx);
    for (int q = 0; q < 3; ++q) {
      if (bulk_ok(vec[q] + j0, bytes)) bulk_copy(st + q * kChunk, vec[q] + j0, bytes, full + i % kStages, policy);
    }
  };
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < kStages && i < m; ++i) fill(i);
  }
  __syncthreads();
  for (int i = 0; i < m; ++i) {
    const long long j0 = first(i);
    const int len = leaves(j0);
    const unsigned bytes = static_cast<unsigned>(len) * sizeof(T);
    const T* st = buf + (i % kStages) * 3 * kChunk;
    mbar_wait(full + i % kStages, (i / kStages) & 1);
    T x[3][kRedItems];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const T* g = bulk_ok(vec[q] + j0, bytes) ? st + q * kChunk : vec[q] + j0;
#pragma unroll
      for (int k = 0; k < kRedItems; ++k) {
        const int l = t + k * kRedThreads;
        x[q][k] = l < len ? g[l] : T(0);
      }
    }
    __syncthreads();  // the stage is read: it may be refilled
    if (t == 0 && i + kStages < m) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      fill(i + kStages);
    }
    T v[3];
    reduce3(x, sh, v);
    if (t == 0) {
      const long long c = j0 / kChunk;
      part[c] = v[0];
      part[nb + c] = v[1];
      part[2 * nb + c] = v[2];
    }
  }
  if (t == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(grid) - 1u;
  }
  __syncthreads();
  if (!last) return;
  int logw = 0;
  while ((1 << logw) < nb) ++logw;
  finish3_serial(part, nb, buf, (1 << logw) <= kStages * kChunk, sh, out);
  if (t == 0) *ticket = 0u;
}

// Sets a kernel's dynamic shared memory once; returns the blocks an SM holds.
template <typename K>
int prepare(K kernel, int smem, cudaError_t* err) {
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int occ = 0;
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kRedThreads, smem);
  return occ;
}

template <typename T, bool Bulk, int Finish>
cudaError_t launch_one(const T* r, const T* u, const T* w, long long n, int nb, T* part, T* out,
                       unsigned* ticket, cudaStream_t s) {
  constexpr int smem = Bulk ? dot3_stage_bytes<T>() : 0;
  static bool set = false;
  if (!set) {
    cudaError_t err;
    prepare(one<T, Bulk, Finish>, smem, &err);
    if (err != cudaSuccess) return err;
    set = true;
  }
  one<T, Bulk, Finish><<<nb, kRedThreads, smem, s>>>(r, u, w, n, part, out, ticket);
  cudaError_t err = cudaGetLastError();
  if (Finish != 2 || err != cudaSuccess) return err;
  repro::tree_finish<T><<<3, kRedThreads, 0, s>>>(part, nb, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int variant, const void* r_, const void* u_, const void* w_, long long n,
                void* part_, void* out_, void* ticket_, cudaStream_t s) {
  const T* r = static_cast<const T*>(r_);
  const T* u = static_cast<const T*>(u_);
  const T* w = static_cast<const T*>(w_);
  T* part = static_cast<T*>(part_);
  T* out = static_cast<T*>(out_);
  unsigned* ticket = static_cast<unsigned*>(ticket_);
  const int nb = repro::chunks(n);
  switch (variant) {
    case 0: {
      two_launch<T><<<nb, kRedThreads, 0, s>>>(r, u, w, n, nb, part);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      repro::tree_finish<T><<<3, kRedThreads, 0, s>>>(part, nb, out);
      return cudaGetLastError();
    }
    case 1: {
      constexpr int smem = static_cast<int>(kStages * 3 * kChunk * sizeof(T));
      static int grid = 0;
      if (!grid) {
        cudaError_t err;
        const int occ = prepare(ring<T>, smem, &err);
        if (err != cudaSuccess) return err;
        int dev = 0, sms = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        grid = occ * sms;
      }
      ring<T><<<nb < grid ? nb : grid, kRedThreads, smem, s>>>(r, u, w, n, nb, part, out, ticket);
      return cudaGetLastError();
    }
    case 2: return launch_one<T, false, 0>(r, u, w, n, nb, part, out, ticket, s);
    case 3: return launch_one<T, false, 1>(r, u, w, n, nb, part, out, ticket, s);
    case 4: return launch_one<T, true, 0>(r, u, w, n, nb, part, out, ticket, s);
    case 5: return launch_one<T, true, 2>(r, u, w, n, nb, part, out, ticket, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// variant: 0 two_launch, 1 ring, 2 one<plain, serial finish>, 3 one<plain,
// tree_sum8 finish>, 4 one<bulk, serial finish>, 5 one<bulk, second launch>.
// dtype 0 fp64, 1 fp32; ticket: 1 unsigned, 0 between calls.
extern "C" int dot3_variant(int variant, int dtype, const void* r, const void* u, const void* w,
                            long long n, void* part, void* out, void* ticket, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? run<double>(variant, r, u, w, n, part, out, ticket, s)
                                     : run<float>(variant, r, u, w, n, part, out, ticket, s));
}
