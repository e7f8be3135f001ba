// Batched banked-ELLPACK SpMV for Hopper (sm_90a).  Replaces the Pallas
// kernel repro/kernels/spmv.py::spmv_pallas_batched and, launched at G = 1,
// the single-system ::spmv_pallas.
//
//   y[g, i, r] = sum over slabs t = 0 .. T-1, in order, of
//                tree_sum_e ( vals[g,i,t,e,r] * x_tile[g, tile_cols[g,i,t]][lcols[g,i,t,e,r]] )
//
// One block per (lane g, row block i), one thread per row.  The TPU kernel
// walks the slabs as a sequential grid axis with y resident in VMEM and the
// x tile in VMEM; Hopper runs blocks in no order, so the slab walk is a loop
// inside the block and the row sum stays in a register.  The reference sums
// over E with an unspecified jnp.sum; this kernel and its plain version both
// fix the order: tree_sum over E, slabs added in order.
//
// Bound: bytes.  Each stored slot is read once (value + int32 local index),
// the tile ids once per slab, x and y once per row; 2 flops per slot.  The
// design keeps the stream moving: no shared memory and no barrier.  x is
// gathered straight through the read-only path (__ldg): an fp64 x of 10^6
// rows is 8 MB and stays in the 50 MB L2, where staging a 4 KB tile per slab
// in shared memory cost a copy of it for every 6 KB of stream and two
// barriers that drained the loads in flight.  For slabs of up to 8 slots
// (the stencils'), slab t + 1's values and indices load before slab t's
// tree, so two slabs' loads are in flight per thread.  The tree over E is
// unrolled at compile time for the padded width wp = next_pow2(E) <= 32, so
// its partials stay in registers (repro::tree_sum's stack lives in local
// memory); above 32 the kernel falls to that generic tree.
#include "tree_sum.cuh"

namespace {

template <int WP, typename V>
__device__ __forceinline__ void load_slab(const V* __restrict__ vp, const int* __restrict__ cp,
                                          int E, int R, V (&v)[WP], int (&c)[WP]) {
#pragma unroll
  for (int e = 0; e < WP; ++e) {
    v[e] = e < E ? __ldg(vp + static_cast<long long>(e) * R) : repro::zero<V>();
    c[e] = e < E ? __ldg(cp + static_cast<long long>(e) * R) : 0;
  }
}

// E <= WP <= 32, WP a power of two.  Up to WP = 8 the next slab's operands
// load before this slab's tree; wider slabs load their own (two slabs' worth
// of fp64 operands at WP = 32 would not fit the 255 registers).
template <int WP, typename V, typename IN, typename ACC>
__global__ void spmv_ellpack_reg(const int* __restrict__ tile_cols, const V* __restrict__ vals,
                                 const int* __restrict__ lcols, const IN* __restrict__ x_tiles,
                                 ACC* __restrict__ y, int B, int T, int E, int n_ct, int C) {
  const int R = blockDim.x;
  const int r = threadIdx.x;
  const long long gi = static_cast<long long>(blockIdx.y) * B + blockIdx.x;
  const IN* xg = x_tiles + static_cast<long long>(blockIdx.y) * n_ct * C;
  const long long slab = static_cast<long long>(E) * R;
  const V* vp = vals + gi * T * slab + r;
  const int* cp = lcols + gi * T * slab + r;
  const int* tp = tile_cols + gi * T;

  constexpr bool kAhead = WP <= 8;
  V v[WP];
  int c[WP];
  int tc = 0;
  if constexpr (kAhead) {
    tc = __ldg(tp);
    load_slab<WP>(vp, cp, E, R, v, c);
  }
  ACC acc = repro::zero<ACC>();
  for (int t = 0; t < T; ++t) {
    if constexpr (!kAhead) {
      tc = __ldg(tp + t);
      load_slab<WP>(vp + t * slab, cp + t * slab, E, R, v, c);
    }
    const IN* xt = xg + static_cast<long long>(tc) * C;
    ACC lv[WP];
#pragma unroll
    for (int e = 0; e < WP; ++e) {
      lv[e] = e < E ? repro::mul_rn(repro::widen<ACC>(v[e]), repro::widen<ACC>(__ldg(xt + c[e])))
                    : repro::zero<ACC>();
    }
    if constexpr (kAhead) {
      // slab t + 1's operands (the last slab reloads its own) before slab t's tree
      const int tn = min(t + 1, T - 1);
      tc = __ldg(tp + tn);
      load_slab<WP>(vp + tn * slab, cp + tn * slab, E, R, v, c);
    }
    repro::fold<WP / 2, WP>(lv);
    acc = repro::add_rn(acc, lv[0]);
  }
  y[gi * R + r] = acc;
}

// E > 32: the generic tree
template <typename V, typename IN, typename ACC>
__global__ void spmv_ellpack_wide(const int* __restrict__ tile_cols, const V* __restrict__ vals,
                                  const int* __restrict__ lcols, const IN* __restrict__ x_tiles,
                                  ACC* __restrict__ y, int B, int T, int E, int n_ct, int C) {
  const int R = blockDim.x;
  const int r = threadIdx.x;
  const long long gi = static_cast<long long>(blockIdx.y) * B + blockIdx.x;
  const IN* xg = x_tiles + static_cast<long long>(blockIdx.y) * n_ct * C;
  ACC acc = repro::zero<ACC>();
  for (int t = 0; t < T; ++t) {
    const IN* xt = xg + static_cast<long long>(__ldg(tile_cols + gi * T + t)) * C;
    const long long base = (gi * T + t) * static_cast<long long>(E) * R + r;
    const ACC s = repro::tree_sum<ACC>(E, [&](int e) {
      const long long q = base + static_cast<long long>(e) * R;
      return repro::mul_rn(repro::widen<ACC>(__ldg(vals + q)),
                           repro::widen<ACC>(__ldg(xt + __ldg(lcols + q))));
    });
    acc = repro::add_rn(acc, s);
  }
  y[gi * R + r] = acc;
}

template <typename V, typename IN, typename ACC>
cudaError_t launch(const void* tile_cols, const void* vals, const void* lcols,
                   const void* x_tiles, void* y, int G, int B, int T, int E,
                   int R, int n_ct, int C, cudaStream_t stream) {
  const dim3 grid(B, G);
  const auto tc = static_cast<const int*>(tile_cols);
  const auto v = static_cast<const V*>(vals);
  const auto lc = static_cast<const int*>(lcols);
  const auto x = static_cast<const IN*>(x_tiles);
  const auto out = static_cast<ACC*>(y);
  if (E <= 1) {
    spmv_ellpack_reg<1, V, IN, ACC><<<grid, R, 0, stream>>>(tc, v, lc, x, out, B, T, E, n_ct, C);
  } else if (E <= 2) {
    spmv_ellpack_reg<2, V, IN, ACC><<<grid, R, 0, stream>>>(tc, v, lc, x, out, B, T, E, n_ct, C);
  } else if (E <= 4) {
    spmv_ellpack_reg<4, V, IN, ACC><<<grid, R, 0, stream>>>(tc, v, lc, x, out, B, T, E, n_ct, C);
  } else if (E <= 8) {
    spmv_ellpack_reg<8, V, IN, ACC><<<grid, R, 0, stream>>>(tc, v, lc, x, out, B, T, E, n_ct, C);
  } else if (E <= 16) {
    spmv_ellpack_reg<16, V, IN, ACC><<<grid, R, 0, stream>>>(tc, v, lc, x, out, B, T, E, n_ct, C);
  } else if (E <= 32) {
    spmv_ellpack_reg<32, V, IN, ACC><<<grid, R, 0, stream>>>(tc, v, lc, x, out, B, T, E, n_ct, C);
  } else {
    spmv_ellpack_wide<V, IN, ACC><<<grid, R, 0, stream>>>(tc, v, lc, x, out, B, T, E, n_ct, C);
  }
  return cudaGetLastError();
}

}  // namespace

// scheme: 0 fp64 (V f64, x f64, acc f64), 1 mixed_v1 and tpu_fp32 (f32, f32, f32),
//         2 mixed_v2 (f32, f32, f64), 3 mixed_v3 (f32, f64, f64),
//         4 tpu_v1 (bf16, bf16, bf16), 5 tpu_v2 (bf16, bf16, f32), 6 tpu_v3 (bf16, f32, f32).
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
    case 4:
      err = launch<repro::bf16, repro::bf16, repro::bf16>(tile_cols, vals, lcols, x_tiles, y,
                                                          G, B, T, E, R, n_ct, C, s);
      break;
    case 5:
      err = launch<repro::bf16, repro::bf16, float>(tile_cols, vals, lcols, x_tiles, y, G, B,
                                                    T, E, R, n_ct, C, s);
      break;
    case 6:
      err = launch<repro::bf16, float, float>(tile_cols, vals, lcols, x_tiles, y, G, B, T, E,
                                              R, n_ct, C, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
