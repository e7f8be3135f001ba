// Batched SELL-C-sigma SpMV for Hopper (sm_90a); row-ELL is its one-group
// case.  Replaces the Pallas kernel repro/kernels/spmv.py::spmv_pallas_sell.
//
//   y_sorted[g, r] = tree_sum_j ( v*x + x*0 ),  v = vals[g, q], x = x[g, cols[g, q]],
//                                               q = base + j*stride + lr
//
// over the slots j < w of sorted row r, where w is lane g's own width in
// r's slice and (base, stride) place the row in its shared width group's
// slot-major [width, rows] block (lr = the row's place in its table entry).
// Slots past w are the +0 pad leaves of tree_sum: the stored layout pads
// every lane to the cross-lane width of the slice, which this kernel never
// reads.
//
// Bound: bytes.  Each slot below a lane's width is read once (value +
// index), x is gathered, y written once; at 2 flops per slot the arithmetic
// is far below the card's rate.
//
// Design.
//  * A per-lane launch table (repro_torch.kernels.spmv.SellTable, device
//    memory, built on the host once per pack) cuts each lane's sorted rows
//    into entries: one shared width group intersected with one run of
//    slices of equal lane width.  A block reads its entry from block_map
//    (-1: past its lane's own blocks, it returns at once), so a 5-wide
//    stencil lane beside a 1,000-wide hub lane streams 5 slots a row, not
//    the hub's width.  The grid holds the most blocks a lane needs for
//    every lane, block b serving lane b mod G: the lanes interleave, so
//    the lanes whose random gathers bound them run beside the ones that
//    stream.
//  * A row of lane width w (wp = next power of two) gets S = clamp(wp/32,
//    1, 32) threads (the table's choice); each holds M = wp / S leaves
//    j = s + S*m and folds them with the halving tree in registers
//    (repro::fold, unrolled for M <= 64; M > 64 takes the generic
//    repro::tree_sum in the kWide instantiation).  Rows sit on consecutive
//    threads, so for a fixed slot the loads are coalesced (the layout is
//    slot-major); narrow rows take one thread each and wide rows up to 32.
//  * The fold over the S threads pairs s with s + S/2 first, as tree_sum
//    does.  Thread q of a row holds subset s = bitrev(q), which puts the
//    first levels' partners in one warp (shuffles) and leaves at most 8
//    partials a row for one shared-memory exchange and one barrier, folded
//    in registers by the thread that writes y.  The whole is exactly
//    tree_sum over wp leaves, bitwise the plain version's.
//  * x stays in device memory and is gathered through the read-only cache:
//    one fp64 lane of 2^18 rows is 2 MB, far above a block's 227 KB of
//    shared memory, while a bag of lanes fits the 50 MB L2.  On a lane
//    whose columns are random, every gather is a 32-byte L2 sector for 8
//    bytes of x: that traffic, not the stream, bounds such lanes.
#include <stdint.h>

#include "tree_sum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kChunk = 8;           // leaves one register tree takes at a time
constexpr int kRegLeaves = 64;      // leaves per thread folded in registers
constexpr int kEntryFields = 8;     // int64 fields of one table entry
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunk * kChunk == kRegLeaves, "chunked_tree folds at most kChunk chunks");

// One launch-table entry, in the order of repro_torch.kernels.spmv.SellTable.
struct Entry {
  int row0;          // first sorted row of the entry
  int rows;          // rows of the entry
  int width;         // the lane's width: slots read per row
  int subsets;       // S, threads per row
  int block0;        // the entry's first block in its lane
  int leaves;        // M = next_pow2(width) / S
  long long base;    // flat slot of slot 0 of the entry's first row
  long long stride;  // slots between slot j and j + 1 of a row (group rows)
};

__device__ __forceinline__ Entry load_entry(const long long* __restrict__ t) {
  Entry e;
  e.row0 = static_cast<int>(__ldg(t + 0));
  e.rows = static_cast<int>(__ldg(t + 1));
  e.width = static_cast<int>(__ldg(t + 2));
  e.subsets = static_cast<int>(__ldg(t + 3));
  e.block0 = static_cast<int>(__ldg(t + 4));
  e.base = __ldg(t + 5);
  e.stride = __ldg(t + 6);
  e.leaves = static_cast<int>(__ldg(t + 7));
  return e;
}

// The slots j of one row, and how a leaf is made of them.
template <typename V, typename I, typename IN>
struct Row {
  const I* __restrict__ cp;   // cols of slot 0 of the row
  const V* __restrict__ vp;   // vals of slot 0 of the row
  const IN* __restrict__ xl;  // the lane's x
  long long stride;
  int width;
};

// batch.rounded_products: round(v*x) + (x*0), which keeps the sign of a zero
// product exactly as the plain version computes it
template <typename ACC>
__device__ __forceinline__ ACC product(ACC v, ACC xv) {
  return repro::add_rn(repro::mul_rn(v, xv), repro::mul_rn(xv, repro::zero<ACC>()));
}

// The K leaves j0 + dj*t (t < K) of a row, folded by the halving tree.  All
// values and indices load before the gathers, the gathers before the tree.
template <int K, typename ACC, typename V, typename I, typename IN>
__device__ __forceinline__ ACC leaf_tree(const Row<V, I, IN>& row, int j0, int dj) {
  I c[K];
  V v[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int j = j0 + dj * t;
    const long long q = static_cast<long long>(j) * row.stride;
    c[t] = j < row.width ? __ldg(row.cp + q) : I(0);
    v[t] = j < row.width ? __ldg(row.vp + q) : repro::zero<V>();
  }
  ACC lv[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int j = j0 + dj * t;
    lv[t] = j < row.width
                ? product(repro::widen<ACC>(v[t]),
                          repro::widen<ACC>(__ldg(row.xl + static_cast<int>(c[t]))))
                : repro::zero<ACC>();  // the +0 pad leaves of tree_sum
  }
  repro::fold<K / 2, K>(lv);
  return lv[0];
}

// M = R * kChunk leaves m: the first log2(kChunk) levels of the tree over m
// pair m with m + R*t, so chunk c is the leaves c + R*t (t < kChunk), folded
// alone; the R chunk sums then take the remaining levels.
template <int R, typename ACC, typename V, typename I, typename IN>
__device__ __forceinline__ ACC chunked_tree(const Row<V, I, IN>& row, int s, int S) {
  ACC cs[R];
#pragma unroll
  for (int c = 0; c < R; ++c) cs[c] = leaf_tree<kChunk, ACC>(row, s + S * c, S * R);
  repro::fold<R / 2, R>(cs);
  return cs[0];
}

// The halving tree over this thread's M leaves j = s + S*m, m < M.
template <bool kWide, typename ACC, typename V, typename I, typename IN>
__device__ __forceinline__ ACC thread_tree(const Row<V, I, IN>& row, int s, int S, int M) {
  switch (M) {
    case 1: return leaf_tree<1, ACC>(row, s, S);
    case 2: return leaf_tree<2, ACC>(row, s, S);
    case 4: return leaf_tree<4, ACC>(row, s, S);
    case 8: return leaf_tree<8, ACC>(row, s, S);
    case 16: return chunked_tree<2, ACC>(row, s, S);
    case 32: return chunked_tree<4, ACC>(row, s, S);
    case 64: return chunked_tree<8, ACC>(row, s, S);
    default:
      break;
  }
  if constexpr (kWide) {
    return repro::tree_sum<ACC>(M, [&](int m) {
      const int j = s + S * m;
      if (j >= row.width) return repro::zero<ACC>();
      const long long q = static_cast<long long>(j) * row.stride;
      return product(repro::widen<ACC>(__ldg(row.vp + q)),
                     repro::widen<ACC>(__ldg(row.xl + static_cast<int>(__ldg(row.cp + q)))));
    });
  } else {
    return repro::zero<ACC>();  // not launched: the host takes kWide when M > kRegLeaves
  }
}

// The last levels of the fold over a row's threads: the P partials of
// subsets s < P, partial s at part[bitrev(s) * rb + r].
template <int P, typename ACC>
__device__ __forceinline__ ACC shared_tree(const ACC* part, int rb, int r) {
  constexpr int kLogP = P == 8 ? 3 : (P == 4 ? 2 : 1);
  ACC a[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int p = static_cast<int>(__brev(static_cast<unsigned>(s)) >> (32 - kLogP));
    a[s] = part[p * rb + r];
  }
  repro::fold<P / 2, P>(a);
  return a[0];
}

template <typename V, typename I, typename IN, typename ACC, bool kWide>
__global__ void __launch_bounds__(kThreads)
spmv_sell_kernel(const I* __restrict__ cols, const V* __restrict__ vals,
                 const IN* __restrict__ x, ACC* __restrict__ y,
                 const long long* __restrict__ table, const int* __restrict__ block_map,
                 int G, long long map_stride, long long L, int n_pad) {
  __shared__ ACC part[kThreads];
  const int g = static_cast<int>(blockIdx.x % G);   // lanes interleave
  const int bx = static_cast<int>(blockIdx.x / G);  // block in the lane
  const int ei = __ldg(block_map + g * map_stride + bx);
  if (ei < 0) return;  // past this lane's own blocks
  const Entry e = load_entry(table + static_cast<long long>(kEntryFields) * ei);
  const int S = e.subsets;
  const int rb = kThreads / S;  // rows per block
  const int tid = threadIdx.x;
  const int q = tid / rb;       // this thread's place among its row's S threads
  const int r = tid - q * rb;   // its row in the block
  const int log_s = 31 - __clz(S);
  const int s = log_s ? static_cast<int>(__brev(static_cast<unsigned>(q)) >> (32 - log_s)) : 0;
  const int lr = (bx - e.block0) * rb + r;
  const bool live = lr < e.rows;
  ACC acc = repro::zero<ACC>();
  if (live && e.width > 0) {
    const long long off = static_cast<long long>(g) * L + e.base + lr;
    const Row<V, I, IN> row{cols + off, vals + off, x + static_cast<long long>(g) * n_pad,
                            e.stride, e.width};
    acc = thread_tree<kWide, ACC>(row, s, S, e.leaves);
  }
  // Level i of the fold pairs s with s + S/2^(i+1), i.e. thread q with
  // q + 2^i, d = 2^i * rb threads on: a shuffle while both sit in one warp.
  int d = rb;
  for (; 2 * d <= kWarp; d *= 2) acc = repro::add_rn(acc, __shfl_down_sync(kFull, acc, d));
  const int P = kThreads / d;  // partials a row has left (S is uniform over the block)
  if (P > 1) {
    if (tid % d < rb) part[(tid / d) * rb + r] = acc;
    __syncthreads();
    if (tid < rb) {
      acc = P == 8 ? shared_tree<8>(part, rb, r)
                   : (P == 4 ? shared_tree<4>(part, rb, r) : shared_tree<2>(part, rb, r));
    }
  }
  if (tid < rb && live) y[static_cast<long long>(g) * n_pad + e.row0 + lr] = acc;
}

template <typename V, typename I, typename IN, typename ACC>
cudaError_t launch(const void* cols, const void* vals, const void* x, void* y, int G,
                   long long L, int n_pad, const void* table, const void* block_map,
                   int grid_x, long long map_stride, int wide, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(grid_x) * static_cast<unsigned>(G);
  const auto c = static_cast<const I*>(cols);
  const auto v = static_cast<const V*>(vals);
  const auto xin = static_cast<const IN*>(x);
  const auto out = static_cast<ACC*>(y);
  const auto t = static_cast<const long long*>(table);
  const auto m = static_cast<const int*>(block_map);
  if (wide) {
    spmv_sell_kernel<V, I, IN, ACC, true><<<grid, kThreads, 0, stream>>>(
        c, v, xin, out, t, m, G, map_stride, L, n_pad);
  } else {
    spmv_sell_kernel<V, I, IN, ACC, false><<<grid, kThreads, 0, stream>>>(
        c, v, xin, out, t, m, G, map_stride, L, n_pad);
  }
  return cudaGetLastError();
}

template <typename V, typename IN, typename ACC>
cudaError_t launch_index(int index_bytes, const void* cols, const void* vals, const void* x,
                         void* y, int G, long long L, int n_pad, const void* table,
                         const void* block_map, int grid_x, long long map_stride, int wide,
                         cudaStream_t stream) {
  if (index_bytes == 2)
    return launch<V, int16_t, IN, ACC>(cols, vals, x, y, G, L, n_pad, table, block_map,
                                       grid_x, map_stride, wide, stream);
  if (index_bytes == 4)
    return launch<V, int32_t, IN, ACC>(cols, vals, x, y, G, L, n_pad, table, block_map,
                                       grid_x, map_stride, wide, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// scheme: 0 fp64 (V f64, x f64, acc f64), 1 mixed_v1 and tpu_fp32 (f32, f32, f32),
//         2 mixed_v2 (f32, f32, f64), 3 mixed_v3 (f32, f64, f64),
//         4 tpu_v1 (bf16, bf16, bf16), 5 tpu_v2 (bf16, bf16, f32), 6 tpu_v3 (bf16, f32, f32).
// table: int64[E, 8] entries; block_map: int32[map_rows, grid_x] entry of
// each block (map_rows 1: one map for every lane; G: one per lane); the
// launch has grid_x * G blocks.  wide: some entry has more than kRegLeaves
// leaves per thread.  Returns cudaGetLastError().
extern "C" int spmv_sell(int scheme, int index_bytes, const void* cols, const void* vals,
                         const void* x, void* y, int G, long long L, int n_pad,
                         const void* table, const void* block_map, int grid_x, int map_rows,
                         int wide, void* stream) {
  if (G < 1 || grid_x < 1 || n_pad < 1 || (map_rows != 1 && map_rows != G) ||
      static_cast<long long>(grid_x) * G > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long map_stride = map_rows == 1 ? 0 : grid_x;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (scheme) {
    case 0:
      return static_cast<int>(launch_index<double, double, double>(
          index_bytes, cols, vals, x, y, G, L, n_pad, table, block_map, grid_x, map_stride,
          wide, s));
    case 1:
      return static_cast<int>(launch_index<float, float, float>(
          index_bytes, cols, vals, x, y, G, L, n_pad, table, block_map, grid_x, map_stride,
          wide, s));
    case 2:
      return static_cast<int>(launch_index<float, float, double>(
          index_bytes, cols, vals, x, y, G, L, n_pad, table, block_map, grid_x, map_stride,
          wide, s));
    case 3:
      return static_cast<int>(launch_index<float, double, double>(
          index_bytes, cols, vals, x, y, G, L, n_pad, table, block_map, grid_x, map_stride,
          wide, s));
    case 4:
      return static_cast<int>(launch_index<repro::bf16, repro::bf16, repro::bf16>(
          index_bytes, cols, vals, x, y, G, L, n_pad, table, block_map, grid_x, map_stride,
          wide, s));
    case 5:
      return static_cast<int>(launch_index<repro::bf16, repro::bf16, float>(
          index_bytes, cols, vals, x, y, G, L, n_pad, table, block_map, grid_x, map_stride,
          wide, s));
    case 6:
      return static_cast<int>(launch_index<repro::bf16, float, float>(
          index_bytes, cols, vals, x, y, G, L, n_pad, table, block_map, grid_x, map_stride,
          wide, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
