// Batched SELL-C-sigma SpMV for Hopper (sm_90a); row-ELL is its one-group
// case.  Replaces the Pallas kernel repro/kernels/spmv.py::spmv_pallas_sell.
//
//   y_sorted[g, r] = tree_sum_j ( v*x + x*0 ),  v = vals[g, off + j*rows + lr]
//                                               x = x[g, cols[g, off + j*rows + lr]]
//
// for sorted row r of width group (rows, w) at flat slot offset off, with
// lr = r - (first row of the group).
//
// Bound: bytes.  Each stored slot is read once (value + index), x is
// gathered, y written once; at 2 flops per slot the arithmetic is far below
// the card's rate.
//
// Design.  A row of width w (wp = next power of two) gets S = min(wp, 32)
// threads; thread s reduces the leaves j = s, s + S, s + 2S, ... with the
// halving tree, then the S partials fold in shared memory, s with s + S/2
// first.  That is exactly tree_sum over the row (its first log2(wp/S)
// levels fold leaves that agree mod S), so the result is bitwise the plain
// version's.  A block of 256 threads covers 256/S rows of one group, rows on
// consecutive threads, so every slot load is coalesced (the layout is slot-
// major).  Splitting wide rows over S threads keeps the hub rows of skewed
// matrices from becoming one long serial chain per row; narrow rows (stencils)
// still cost one leaf per thread.  x stays in device memory and is gathered
// through the read-only cache: one fp64 lane of 2^18 rows is 2 MB, far above
// a block's 227 KB of shared memory, while a bag of lanes fits the 50 MB L2.
#include <stdint.h>

#include "tree_sum.cuh"

namespace {

constexpr int kMaxGroups = 32;  // width groups per launch (by-value table)
constexpr int kThreads = 256;
constexpr int kMaxSubsets = 32;  // threads per row at most

struct GroupTable {
  int n;                       // groups in this launch
  int row0[kMaxGroups];        // first sorted row of each group
  int rows[kMaxGroups];        // rows of each group
  int width[kMaxGroups];       // slots per row of each group
  int subsets[kMaxGroups];     // threads per row, S
  int block0[kMaxGroups];      // first block of each group in this launch
  long long off[kMaxGroups];   // flat slot offset of each group's [w, rows] block
};

template <typename V, typename I, typename IN, typename ACC>
__global__ void __launch_bounds__(kThreads)
spmv_sell_kernel(const I* __restrict__ cols, const V* __restrict__ vals,
                 const IN* __restrict__ x, ACC* __restrict__ y,
                 const GroupTable tab, long long L, int n_pad) {
  __shared__ ACC part[kThreads];
  const int g = blockIdx.y;
  const int blk = blockIdx.x;
  int k = 0;
  while (k + 1 < tab.n && blk >= tab.block0[k + 1]) ++k;
  const int S = tab.subsets[k];
  const int rb = kThreads / S;  // rows per block
  const int tid = threadIdx.x;
  const int s = tid / rb;       // this thread's leaf subset
  const int lr = (blk - tab.block0[k]) * rb + tid % rb;  // row in the group
  const int w = tab.width[k];
  const bool live = lr < tab.rows[k];
  ACC acc = ACC(0);
  if (live && w > 0) {
    int wp = 1;
    while (wp < w) wp <<= 1;
    const long long rows = tab.rows[k];
    const long long base = static_cast<long long>(g) * L + tab.off[k] + lr;
    const IN* xl = x + static_cast<long long>(g) * n_pad;
    const ACC zero = ACC(0);
    acc = repro::tree_sum<ACC>(wp / S, [&](int m) {
      const int j = s + S * m;
      if (j >= w) return zero;  // the +0 pad leaves of tree_sum
      const long long q = base + j * rows;
      const ACC xv = static_cast<ACC>(__ldg(xl + static_cast<int>(__ldg(cols + q))));
      const ACC v = static_cast<ACC>(__ldg(vals + q));
      // batch.rounded_products: round(v*x) + (x*0), which keeps the sign
      // of a zero product exactly as the plain version computes it
      return repro::add_rn(repro::mul_rn(v, xv), repro::mul_rn(xv, zero));
    });
  }
  part[tid] = acc;
  for (int h = S / 2; h >= 1; h >>= 1) {  // S is uniform over the block
    __syncthreads();
    if (s < h) part[tid] = repro::add_rn(part[tid], part[tid + h * rb]);
  }
  if (s == 0 && live) y[static_cast<long long>(g) * n_pad + tab.row0[k] + lr] = part[tid];
}

template <typename V, typename I, typename IN, typename ACC>
cudaError_t launch(const void* cols, const void* vals, const void* x, void* y,
                   int G, long long L, int n_pad, const GroupTable& tab,
                   int blocks, cudaStream_t stream) {
  dim3 grid(blocks, G);
  spmv_sell_kernel<V, I, IN, ACC><<<grid, kThreads, 0, stream>>>(
      static_cast<const I*>(cols), static_cast<const V*>(vals),
      static_cast<const IN*>(x), static_cast<ACC*>(y), tab, L, n_pad);
  return cudaGetLastError();
}

template <typename V, typename IN, typename ACC>
cudaError_t launch_index(int index_bytes, const void* cols, const void* vals,
                         const void* x, void* y, int G, long long L, int n_pad,
                         const GroupTable& tab, int blocks,
                         cudaStream_t stream) {
  if (index_bytes == 2)
    return launch<V, int16_t, IN, ACC>(cols, vals, x, y, G, L, n_pad, tab,
                                       blocks, stream);
  if (index_bytes == 4)
    return launch<V, int32_t, IN, ACC>(cols, vals, x, y, G, L, n_pad, tab,
                                       blocks, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// scheme: 0 fp64 (V f64, x f64, acc f64), 1 mixed_v1 (f32, f32, f32),
//         2 mixed_v2 (f32, f32, f64), 3 mixed_v3 (f32, f64, f64).
// Groups row0/rows/width/off are host arrays of n_groups <= 32 entries.
// Returns cudaGetLastError().
extern "C" int spmv_sell(int scheme, int index_bytes, const void* cols,
                         const void* vals, const void* x, void* y, int G,
                         long long L, int n_pad, int n_groups,
                         const int* row0, const int* rows, const int* width,
                         const long long* off, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups || G < 1 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  GroupTable tab;
  tab.n = n_groups;
  long long blocks = 0;
  for (int i = 0; i < n_groups; ++i) {
    if (rows[i] < 0 || width[i] < 0 || width[i] > (1 << 30))
      return static_cast<int>(cudaErrorInvalidValue);
    int wp = 1;
    while (wp < width[i]) wp <<= 1;
    const int S = width[i] > 0 ? (wp < kMaxSubsets ? wp : kMaxSubsets) : 1;
    const int rb = kThreads / S;
    tab.row0[i] = row0[i];
    tab.rows[i] = rows[i];
    tab.width[i] = width[i];
    tab.subsets[i] = S;
    tab.block0[i] = static_cast<int>(blocks);
    tab.off[i] = off[i];
    blocks += (rows[i] + rb - 1) / rb;
  }
  if (blocks < 1 || blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  cudaError_t err;
  switch (scheme) {
    case 0:
      err = launch_index<double, double, double>(index_bytes, cols, vals, x, y, G, L, n_pad,
                                                 tab, nb, s);
      break;
    case 1:
      err = launch_index<float, float, float>(index_bytes, cols, vals, x, y, G, L, n_pad, tab,
                                              nb, s);
      break;
    case 2:
      err = launch_index<float, float, double>(index_bytes, cols, vals, x, y, G, L, n_pad, tab,
                                               nb, s);
      break;
    case 3:
      err = launch_index<float, double, double>(index_bytes, cols, vals, x, y, G, L, n_pad,
                                                tab, nb, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
