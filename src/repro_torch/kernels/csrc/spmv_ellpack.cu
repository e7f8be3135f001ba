// Batched banked-ELLPACK SpMV for Hopper (sm_90a).  Replaces the Pallas
// kernel repro/kernels/spmv.py::spmv_pallas_batched.
//
//   y[g, i, r] = sum over slabs t = 0 .. T-1, in order, of
//                tree_sum_e ( vals[g,i,t,e,r] * x_tile[g, tile_cols[g,i,t]][lcols[g,i,t,e,r]] )
//
// One block per (lane g, row block i), one thread per row.  The TPU kernel
// walks the slabs as a sequential grid axis with y resident in VMEM; Hopper
// runs blocks in no order, so the slab walk is a loop inside the block and
// the row sum stays in a register.  Each slab's C-wide x tile is staged in
// shared memory (C = 512 fp64 is 4 KB) so the gather hits shared memory.
// The reference sums over E with an unspecified jnp.sum; this kernel and its
// plain version both fix the order: tree_sum over E, slabs added in order.
//
// Bound: bytes.  Each stored slot is read once (value + int32 local index),
// the tile ids and x tiles once per slab, y written once; 2 flops per slot.
#include "tree_sum.cuh"

namespace {

template <typename V, typename IN, typename ACC>
__global__ void spmv_ellpack_kernel(const int* __restrict__ tile_cols,
                                    const V* __restrict__ vals,
                                    const int* __restrict__ lcols,
                                    const IN* __restrict__ x_tiles,
                                    ACC* __restrict__ y, int B, int T, int E,
                                    int n_ct, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  IN* xs = reinterpret_cast<IN*>(smem);
  const int R = blockDim.x;
  const int r = threadIdx.x;
  const long long gi = static_cast<long long>(blockIdx.y) * B + blockIdx.x;
  ACC acc = ACC(0);
  for (int t = 0; t < T; ++t) {
    const int tc = tile_cols[gi * T + t];
    const IN* xt = x_tiles + (static_cast<long long>(blockIdx.y) * n_ct + tc) * C;
    __syncthreads();  // every row is done with the previous slab's tile
    for (int c = r; c < C; c += R) xs[c] = xt[c];
    __syncthreads();
    const long long base = (gi * T + t) * static_cast<long long>(E) * R + r;
    const ACC s = repro::tree_sum<ACC>(E, [&](int e) {
      const long long q = base + static_cast<long long>(e) * R;
      return repro::mul_rn(static_cast<ACC>(vals[q]), static_cast<ACC>(xs[lcols[q]]));
    });
    acc = repro::add_rn(acc, s);
  }
  y[gi * R + r] = acc;
}

template <typename V, typename IN, typename ACC>
cudaError_t launch(const void* tile_cols, const void* vals, const void* lcols,
                   const void* x_tiles, void* y, int G, int B, int T, int E,
                   int R, int n_ct, int C, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(C) * sizeof(IN);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid(B, G);
  spmv_ellpack_kernel<V, IN, ACC><<<grid, R, smem, stream>>>(
      static_cast<const int*>(tile_cols), static_cast<const V*>(vals),
      static_cast<const int*>(lcols), static_cast<const IN*>(x_tiles),
      static_cast<ACC*>(y), B, T, E, n_ct, C);
  return cudaGetLastError();
}

}  // namespace

// scheme: 0 fp64 (V f64, x f64, acc f64), 1 mixed_v1 (f32, f32, f32),
//         2 mixed_v2 (f32, f32, f64), 3 mixed_v3 (f32, f64, f64).
// Shapes: tile_cols [G,B,T], vals/lcols [G,B,T,E,R], x_tiles [G,n_ct,C],
// y [G,B,R].  Returns cudaGetLastError().
extern "C" int spmv_ellpack(int scheme, const void* tile_cols, const void* vals,
                            const void* lcols, const void* x_tiles, void* y,
                            int G, int B, int T, int E, int R, int n_ct, int C,
                            void* stream) {
  if (G < 1 || G > 65535 || B < 1 || T < 1 || E < 1 || R < 1 || R > 1024 ||
      n_ct < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (scheme) {
    case 0:
      err = launch<double, double, double>(tile_cols, vals, lcols, x_tiles, y, G, B, T, E,
                                           R, n_ct, C, s);
      break;
    case 1:
      err = launch<float, float, float>(tile_cols, vals, lcols, x_tiles, y, G, B, T, E, R,
                                        n_ct, C, s);
      break;
    case 2:
      err = launch<float, float, double>(tile_cols, vals, lcols, x_tiles, y, G, B, T, E, R,
                                         n_ct, C, s);
      break;
    case 3:
      err = launch<float, double, double>(tile_cols, vals, lcols, x_tiles, y, G, B, T, E, R,
                                          n_ct, C, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
