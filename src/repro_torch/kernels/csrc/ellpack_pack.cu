// CSR to banked, slot-major ELLPACK on the card (sm_90a), and the Jacobi
// diagonal beside it.  Replaces no TPU kernel: the JAX package packs on the
// host (repro/sparse/ellpack.py::csr_to_ellpack, then stacking.pad_ellpack
// and a copy of the padded lane).  The port added it because that host
// packing, and the copy of the padded lane it produces, set the pace of the
// solver engine's admissions and of the single-system operator build; here
// only the CSR crosses the bus.  The plain PyTorch version, equal byte for
// byte, is repro_torch/kernels/pack.py::ellpack_pack_plain.
//
// Two passes, one block of round_up(block_rows, 32) threads per row block,
// one thread per row:
//   * ellpack_geometry: each block marks the col tiles its rows touch in a
//     shared-memory bitmap and counts them (the block's slabs), and each
//     row counts its entries per tile (the block's slots); atomicMax folds
//     both into the matrix's (T, ell).  The host reads those two ints.
//   * ellpack_scatter: each block marks its tiles again, ranks them (a block
//     scan of the bitmap words' popcounts) into tile_cols[b, :], then each
//     thread walks its row once per slab and writes all of that slab's
//     slots for its row: the e-th entry of the row in the slab's tile, in
//     CSR order, or a zero.  Every slot of the given (bucketed) dims is
//     written, so nothing of an earlier occupant survives and no memset is
//     needed; blocks past the matrix's rows write zeros and unit diagonals.
// The bitmap covers the block's tile span in windows of 32,768 tiles, so a
// banded matrix (ecology2: a block spans ~5 of 1,954 tiles) takes one small
// window and a wide one takes as many as it needs.  A row whose tiles do
// not decrease in CSR order (sorted columns) walks its entries once over
// all slabs; any other row rescans its entries for each slab, which keeps
// the slot of unsorted and duplicate entries where the host's stable sort
// puts them.
//
// Values round from fp64 to the scheme's matrix dtype as the host path's
// CPU casts round them: fp32 to nearest even, bf16 through fp32 then to
// nearest even on the 16 dropped bits (precision.bf16_bits), a NaN as x86
// converts it (sign and the payload's top bits kept, quiet bit set).  The
// diagonal is the last entry of row i at column i in CSR order (0 where
// there is none), at the vector dtype; rows past the matrix get 1.
//
// Bound: bytes.  The function needs the CSR read once and the lane written
// once (tile ids, slot values and local columns, and the diagonal); this
// design reads indptr and indices a second time, in the geometry pass,
// and each row's indices again from L1 for its slabs in the scatter pass,
// since the lane's dims must be known before a slot is placed.  No
// floating-point arithmetic; integer atomics only for max and sums, so
// every run writes the same bytes.
#include <climits>
#include <cstdint>

#include "tree_sum.cuh"  // repro_cuda_error_string

namespace {

constexpr int kWindowWords = 1024;                // 4 KB of bitmap a window
constexpr int kWindowTiles = kWindowWords * 32;  // col tiles a window covers

// fp64 to fp32 as x86's cvtsd2ss: round to nearest even; a NaN keeps its
// sign and the top 23 bits of its payload, with the quiet bit set.
__device__ __forceinline__ float to_f32(double v) {
  if (v != v) {
    const unsigned long long d = static_cast<unsigned long long>(__double_as_longlong(v));
    const unsigned u = static_cast<unsigned>((d >> 32) & 0x80000000ull) | 0x7FC00000u |
                       static_cast<unsigned>((d >> 29) & 0x7FFFFFull);
    return __uint_as_float(u);
  }
  return __double2float_rn(v);
}

// bf16 bits as precision.bf16_bits rounds them.
__device__ __forceinline__ uint16_t to_bf16_bits(double v) {
  const unsigned u = __float_as_uint(to_f32(v));
  if (v != v) return static_cast<uint16_t>((u >> 16) | 0x40u);
  return static_cast<uint16_t>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

template <typename T>
struct Store;
template <>
struct Store<double> {
  __device__ static double of(double v) { return v; }
};
template <>
struct Store<float> {
  __device__ static float of(double v) { return to_f32(v); }
};
template <>
struct Store<uint16_t> {  // bf16, as its bits
  __device__ static uint16_t of(double v) { return to_bf16_bits(v); }
};

struct RowSpan {
  long long lo = 0, hi = 0;  // the row's entries in the CSR
  int tmin = INT_MAX, tmax = INT_MIN;
  bool sorted = true;  // tiles non-decreasing in CSR order
};

__device__ __forceinline__ RowSpan row_span(const long long* __restrict__ indptr,
                                            const int* __restrict__ idx, long long n_rows,
                                            int R, int C) {
  RowSpan s;
  const long long row = static_cast<long long>(blockIdx.x) * R + threadIdx.x;
  if (static_cast<int>(threadIdx.x) >= R || row >= n_rows) return s;
  s.lo = indptr[row];
  s.hi = indptr[row + 1];
  int prev = INT_MIN;
  for (long long k = s.lo; k < s.hi; ++k) {
    const int t = idx[k] / C;
    s.tmin = min(s.tmin, t);
    s.tmax = max(s.tmax, t);
    s.sorted = s.sorted && t >= prev;
    prev = t;
  }
  return s;
}

// The block's tile span [lo, hi] into shared (lo > hi when it has no entry).
__device__ __forceinline__ void block_span(const RowSpan& s, int* sh_lo, int* sh_hi) {
  if (threadIdx.x == 0) {
    *sh_lo = INT_MAX;
    *sh_hi = INT_MIN;
  }
  __syncthreads();
  if (s.hi > s.lo) {
    atomicMin(sh_lo, s.tmin);
    atomicMax(sh_hi, s.tmax);
  }
  __syncthreads();
}

// Marks the tiles in [w0, w0 + 32 * nw) that this thread's row touches in
// bits[0, nw), after clearing them; the block's marks are complete on return.
__device__ __forceinline__ void mark_window(unsigned* bits, int nw, long long w0,
                                            const int* __restrict__ idx, const RowSpan& s,
                                            int C) {
  for (int i = threadIdx.x; i < nw; i += blockDim.x) bits[i] = 0u;
  __syncthreads();
  for (long long k = s.lo; k < s.hi; ++k) {
    const long long t = idx[k] / C - w0;
    if (t >= 0 && t < 32LL * nw) atomicOr(&bits[t >> 5], 1u << (t & 31));
  }
  __syncthreads();
}

__device__ __forceinline__ int window_words(long long w0, int span_hi) {
  return static_cast<int>(min(static_cast<long long>(kWindowWords), (span_hi - w0) / 32 + 1));
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// *total gets the sum.  Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sh_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? sh_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += y;
    }
    sh_warp[lane] = w;
  }
  __syncthreads();
  const int base = warp ? sh_warp[warp - 1] : 0;
  *total = sh_warp[n_warps - 1];
  __syncthreads();  // sh_warp is free again
  return base + x - v;
}

// Largest number of the row's entries in one tile.
__device__ __forceinline__ int row_ell(const int* __restrict__ idx, const RowSpan& s, int C) {
  int best = 0;
  if (s.sorted) {  // a tile's entries are one run
    int prev = INT_MIN, run = 0;
    for (long long k = s.lo; k < s.hi; ++k) {
      const int t = idx[k] / C;
      run = t == prev ? run + 1 : 1;
      best = max(best, run);
      prev = t;
    }
    return best;
  }
  for (long long k = s.lo; k < s.hi; ++k) {
    const int t = idx[k] / C;
    int c = 0;
    for (long long q = s.lo; q < s.hi; ++q) c += idx[q] / C == t;
    best = max(best, c);
  }
  return best;
}

__global__ void ellpack_geometry(const long long* __restrict__ indptr,
                                 const int* __restrict__ idx, long long n_rows, int R, int C,
                                 int* __restrict__ out) {
  __shared__ unsigned bits[kWindowWords];
  __shared__ int sh_lo, sh_hi, sh_tiles, sh_ell;
  const RowSpan s = row_span(indptr, idx, n_rows, R, C);
  if (threadIdx.x == 0) sh_tiles = sh_ell = 0;
  block_span(s, &sh_lo, &sh_hi);
  const int lo = sh_lo, hi = sh_hi;
  const int ell = row_ell(idx, s, C);
  if (ell) atomicMax(&sh_ell, ell);
  int tiles = 0;
  for (long long w0 = lo; w0 <= hi; w0 += kWindowTiles) {
    const int nw = window_words(w0, hi);
    mark_window(bits, nw, w0, idx, s, C);
    for (int i = threadIdx.x; i < nw; i += blockDim.x) tiles += __popc(bits[i]);
    __syncthreads();  // the next window clears the bitmap
  }
  if (tiles) atomicAdd(&sh_tiles, tiles);
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicMax(out, sh_tiles);
    atomicMax(out + 1, sh_ell);
  }
}

template <typename M, typename V>
__global__ void ellpack_scatter(const long long* __restrict__ indptr,
                                const int* __restrict__ idx, const double* __restrict__ data,
                                long long n_rows, int R, int C, int T, int L, int* tile_cols,
                                M* __restrict__ vals, int* __restrict__ lcols,
                                V* __restrict__ diag) {
  __shared__ unsigned bits[kWindowWords];
  __shared__ int sh_lo, sh_hi, sh_warp[32];
  const int r = threadIdx.x;
  const long long b = blockIdx.x;
  const RowSpan s = row_span(indptr, idx, n_rows, R, C);
  block_span(s, &sh_lo, &sh_hi);
  const int lo = sh_lo, hi = sh_hi;

  // The block's tiles, ascending, are its slabs: tile_cols[b, :n_tiles].
  int* tc = tile_cols + b * T;
  int n_tiles = 0;
  for (long long w0 = lo; w0 <= hi; w0 += kWindowTiles) {
    const int nw = window_words(w0, hi);
    mark_window(bits, nw, w0, idx, s, C);
    const int per = (nw + blockDim.x - 1) / blockDim.x;  // words a thread ranks
    const int i0 = min(nw, r * per), i1 = min(nw, i0 + per);
    int mine = 0;
    for (int i = i0; i < i1; ++i) mine += __popc(bits[i]);
    int total;
    int slab = n_tiles + block_exclusive_scan(mine, sh_warp, &total);
    for (int i = i0; i < i1; ++i) {
      for (unsigned w = bits[i]; w; w &= w - 1, ++slab) {
        if (slab < T) tc[slab] = static_cast<int>(w0 + 32LL * i + __ffs(w) - 1);
      }
    }
    n_tiles += total;
    __syncthreads();  // the next window clears the bitmap
  }
  for (int t = n_tiles + r; t < T; t += blockDim.x) tc[t] = 0;
  __syncthreads();  // tile_cols[b, :] is the block's to read
  if (r >= R) return;

  const long long row = b * R + r;
  double dv = 1.0;  // rows past the matrix
  if (row < n_rows) {
    dv = 0.0;
    for (long long k = s.lo; k < s.hi; ++k)
      if (idx[k] == row) dv = data[k];
  }
  diag[row] = Store<V>::of(dv);

  const long long slot_stride = R;
  long long p = s.lo;  // sorted rows: the first entry not yet placed
  for (int t = 0; t < T; ++t) {
    const long long base = (b * T + t) * static_cast<long long>(L) * R + r;
    M* vp = vals + base;
    int* cp = lcols + base;
    if (t >= n_tiles) {
      for (int e = 0; e < L; ++e) {
        vp[e * slot_stride] = Store<M>::of(0.0);
        cp[e * slot_stride] = 0;
      }
      continue;
    }
    const int tile = tc[t];
    long long k = s.sorted ? p : s.lo;
    for (int e = 0; e < L; ++e) {
      int kt = 0;
      while (k < s.hi) {
        kt = idx[k] / C;
        if (kt == tile || (s.sorted && kt > tile)) break;
        ++k;
      }
      const bool hit = k < s.hi && kt == tile;
      vp[e * slot_stride] = Store<M>::of(hit ? data[k] : 0.0);
      cp[e * slot_stride] = hit ? idx[k] - tile * C : 0;
      k += hit;
    }
    if (s.sorted) p = k;
  }
}

template <typename M, typename V>
cudaError_t launch_scatter(const void* indptr, const void* indices, const void* data,
                           long long n_rows, int R, int C, int B, int T, int L,
                           void* tile_cols, void* vals, void* lcols, void* diag,
                           cudaStream_t s) {
  const int threads = (R + 31) / 32 * 32;
  ellpack_scatter<M, V><<<B, threads, 0, s>>>(
      static_cast<const long long*>(indptr), static_cast<const int*>(indices),
      static_cast<const double*>(data), n_rows, R, C, T, L, static_cast<int*>(tile_cols),
      static_cast<M*>(vals), static_cast<int*>(lcols), static_cast<V*>(diag));
  return cudaGetLastError();
}

}  // namespace

// indptr int64[n_rows + 1], indices int32[nnz]; `out` int32[2], zeroed by the
// caller, gets (T, ell): the most slabs of a row block and the most entries of
// a row in one col tile.  n_blocks = ceil(n_rows / block_rows).
extern "C" int repro_ellpack_geometry(const void* indptr, const void* indices,
                                      long long n_rows, int block_rows, int col_tile,
                                      int n_blocks, void* out, void* stream) {
  if (n_rows < 0 || block_rows < 1 || block_rows > 1024 || col_tile < 1 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (block_rows + 31) / 32 * 32;
  ellpack_geometry<<<n_blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(indptr), static_cast<const int*>(indices), n_rows,
      block_rows, col_tile, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Writes every slot of a lane of dims (B, T, L, block_rows): tile_cols
// int32[B, T], vals [B, T, L, block_rows] at matrix code 0 fp64, 1 fp32, 2
// bf16 (its bits), local_cols int32 of the same shape, and diag [B *
// block_rows] at vector code 0 fp64, 1 fp32.  data is fp64[nnz].  (T, L) must
// be at least the geometry's; B at least ceil(n_rows / block_rows).
extern "C" int repro_ellpack_scatter(int matrix_code, int vector_code, const void* indptr,
                                     const void* indices, const void* data, long long n_rows,
                                     int block_rows, int col_tile, int B, int T, int L,
                                     void* tile_cols, void* vals, void* local_cols,
                                     void* diag, void* stream) {
  if (n_rows < 0 || block_rows < 1 || block_rows > 1024 || col_tile < 1 || B < 1 || T < 1 ||
      L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SCATTER(M, V)                                                                  \
  launch_scatter<M, V>(indptr, indices, data, n_rows, block_rows, col_tile, B, T, L,        \
                       tile_cols, vals, local_cols, diag, s)
  switch (matrix_code * 2 + vector_code) {
    case 0: return static_cast<int>(REPRO_SCATTER(double, double));
    case 1: return static_cast<int>(REPRO_SCATTER(double, float));
    case 2: return static_cast<int>(REPRO_SCATTER(float, double));
    case 3: return static_cast<int>(REPRO_SCATTER(float, float));
    case 4: return static_cast<int>(REPRO_SCATTER(uint16_t, double));
    case 5: return static_cast<int>(REPRO_SCATTER(uint16_t, float));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SCATTER
}
