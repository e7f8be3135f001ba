// Flash attention (forward) for Hopper (sm_90a).  Replaces the Pallas kernel
// repro/kernels/flash_attn.py::flash_attention (body _kernel): online-softmax
// attention on the head-major layout [BH, S, D], causal and/or sliding-window
// mask, fp32 scores and statistics, output acc / max(l, 1e-30) at the input
// dtype.  Its plain version is repro_torch.kernels.flash_attn.
// flash_attention_plain (the reference's kernels/ref.py::mha_ref).
//
// What it computes is the reference kernel's step, per live K tile:
//   s = q.k * scale, masked to -1e30 (keys past T: -inf, so they add nothing);
//   m' = max(m, rowmax s); corr = exp(m - m'); p = exp(s - m');
//   l = l * corr + rowsum p; acc = acc * corr + p.v; m = m'.
// Positions of q and k both count from 0: key j is live for query i when
// j <= i (causal) and j > i - window (window >= 0; the 64-bit width takes
// gemma3's 2^24 "no window").  A K tile the mask leaves wholly dead is
// skipped, as the reference's pl.when(live) does; the heaviest causal query
// tiles start first.
//
// Two kernels, one per input dtype.
//
// flash_fwd_bf16 (bf16 inputs; bf16 out, or fp32 out for a private check):
// since csrc/flash_attn_sm90.cu (TMA and wgmma, about twice as fast at every
// shape of the main path) this is the route only for bf16 inputs that TMA
// cannot take: a head dim that is not a multiple of 8 (rows of 2 D bytes that
// are not 16-byte aligned, as D = 20) or a base pointer off a 16-byte
// boundary (a view into its storage).  repro_torch.kernels.flash_attn._route
// picks it by shape, before the launch.  It keeps its element-wise loads for
// those inputs and its cp.async loads for the rest, which only a forced route
// (the smoke's A/B) sends here.
// Bound: operations on the tensor cores.  Per live (query, key) pair, q.k is
// 2 D flops of bf16 x bf16 (exact in fp32), and p.v is 2 D flops taken twice:
// p is fp32, carried to 16 bits as p_hi = bf16(p) and p_lo = bf16(p - p_hi)
// (the subtraction is exact), each against bf16 v.  So 3 x 2 D flops per pair
// at the 989 TFLOP/s bf16 peak; the bytes (q, k, v read once, o written once)
// are a fifth of that time at gemma3's S = 4,096.  Design: one block of 8
// warps per (bh, 128 query rows), blocks ordered so the heaviest causal
// query tiles of every head start first; each warp owns 16 rows and runs
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) on fragments read with
// ldmatrix two steps ahead of their products: S = Q K^T into 16 x 64 fp32
// scores, then O += P V with P taken from the score registers (hi and lo).
// The 16 x D fp32 accumulator stays in registers (D / 2 a thread: 128 at
// D = 256, which holds the block to 8 warps an SM), and is rescaled only when
// some row's max moved.  Q and a two-stage ring of 64-key K/V tiles stay at
// bf16 in shared memory (rows padded by 16 bytes, so ldmatrix's eight rows
// fall in eight bank groups; 198 KB at D = 256), filled by cp.async 16 bytes
// a thread: tile k + 1 loads while tile k multiplies, and one barrier a tile
// publishes the arrived tile and frees the other stage.  D is zero-padded to
// a power of two >= 16 in shared memory (zero columns of q and k add nothing;
// padded columns of o are not written; a D between powers of two pays for
// the padding).  A warp skips a tile its own rows leave dead and masks per
// element only on the tiles that cross T, the diagonal or the window's edge.
// Softmax runs in base 2 on scores pre-scaled by scale * log2(e).  Row max
// reduces over the four lanes of a quad; each lane keeps a partial l, summed
// over the quad at the end.  What holds it back: mma.sync with 8 warps an SM
// reaches a fraction of the tensor cores' rate, and the softmax of a tile runs
// between its two products in every warp at once; flash_attn_sm90.cu's wgmma
// and TMA remove both where the shape allows.
//
// flash_fwd_fp32 (fp32 inputs and output): since csrc/flash_attn_tf32.cu
// (three TF32 products on wgmma) this is the route only for fp32 inputs whose
// head dim is at most 32 or not a multiple of 4, or whose base is off a
// 16-byte boundary; _route picks it by shape, and a forced route (the smoke's
// A/B) sends any fp32 input here.  Its q.k is fp32 FMAs over D one column
// after another; the reference test's x30-logit case (D = 32, logits near
// 1e3) holds its 1e-4 gate in that order, where sums over D in other orders
// (the tensor cores', or these FMAs reversed) miss it on some inputs.  Both
// products are fp32 FMAs on the CUDA cores (fmaf: --fmad=false does not apply
// to explicit FMAs).  Bound: operations, 4 D flops per live pair at
// 67 TFLOP/s.  One block of 256 threads per (bh, 64 query rows); Q
// (transposed), K (transposed), V and the probabilities at fp32 in 214 KB of
// shared memory at D = 256; thread (ty, tx) of a 16 x 16 grid holds 4 x 4
// scores and 4 x ceil(D / 16) accumulators; loads and products alternate
// behind barriers.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tree_sum.cuh"  // repro_cuda_error_string

namespace {

constexpr float kNeg = -1e30f;   // the reference's _NEG

__device__ __forceinline__ float to_out(float x, const float*) { return x; }
// float -> bfloat16 bits, round to nearest even; NaN -> 0x7fc0 (torch's cast)
__device__ __forceinline__ uint16_t to_out(float x, const uint16_t*) {
  const unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// ------------------------------------------------- bf16: tensor cores
constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBQ = 16 * kTcWarps;  // query rows per block, 16 a warp
constexpr int kTcBK = 64;             // keys per tile
constexpr int kTcNT = kTcBK / 8;      // score n-tiles of 8 keys

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and register i holds matrix i's (row lane / 4, cols 2 (lane % 4)
// and + 1) — or, transposed, (rows 2 (lane % 4) and + 1, col lane / 4).
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// (p0, p1) -> hi = bf16(p), lo = bf16(p - hi), each a packed pair
__device__ __forceinline__ void split_p(float p0, float p1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(p0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(p1 - __bfloat162float(h1)));
}

// Rows [row0, row0 + kN) of src [n_rows, d] into dst (row stride ld);
// rows past n_rows are zeros, columns >= d untouched.  vec: d % 8 == 0 and
// 16-byte aligned rows, copied by cp.async; else plain loads and stores.
template <int kN>
__device__ __forceinline__ void load_tile(const uint16_t* __restrict__ src, int row0,
                                          int n_rows, int d, int ld, bool vec, uint16_t* dst) {
  if (vec) {
    const int cpr = d >> 3;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < kN * cpr; i += kTcThreads) {
      const int r = i / cpr, c = (i - r * cpr) << 3;
      uint16_t* to = dst + r * ld + c;
      if (row0 + r < n_rows) {
        cp_async16(smem_u32(to), src + static_cast<long long>(row0 + r) * d + c);
      } else {
        *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kN * d; i += kTcThreads) {
      const int r = i / d, c = i - r * d;
      dst[r * ld + c] = row0 + r < n_rows ? src[static_cast<long long>(row0 + r) * d + c]
                                          : static_cast<uint16_t>(0);
    }
  }
}

template <typename OUT, int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v, OUT* __restrict__ out, int s_len, int t_len,
                   int d, int n_bh, int causal, long long window, float scale_log2,
                   int vec) {
  constexpr int LD = DP + 8;        // row stride: 16 bytes of padding, odd in 16-byte units
  constexpr int kStage = 2 * kTcBK * LD;
  constexpr int DT = DP / 8;        // accumulator n-tiles of 8 columns
  constexpr int kNP = kTcNT / 2;    // K fragments (pairs of 8 keys) a k-step
  constexpr int kSS = DP / 16 * kNP;      // steps of q.k
  constexpr int kDPN = DP / 16;           // V fragments (pairs of 8 columns) a key step
  constexpr int kPS = kTcBK / 16 * kDPN;  // steps of p.v
  extern __shared__ __align__(16) uint16_t tc_smem[];
  uint16_t* qs = tc_smem;           // [kTcBQ][LD]
  uint16_t* kv = qs + kTcBQ * LD;   // 2 stages of K [kTcBK][LD] then V [kTcBK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // block b takes query tile n_qt - 1 - b / n_bh of head b % n_bh: the
  // heaviest causal tiles of every head start first
  const int n_qt = (s_len + kTcBQ - 1) / kTcBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / n_bh)) * kTcBQ;
  const long long bh = blockIdx.x % n_bh;
  const uint16_t* qb = q + bh * s_len * d;
  const uint16_t* kb = k + bh * t_len * d;
  const uint16_t* vb = v + bh * t_len * d;

  // the padded columns [d, DP) of Q and of both stages stay zero
  if (d < DP) {
    const int pad = DP - d;
    for (int i = tid; i < (kTcBQ + 4 * kTcBK) * pad; i += kTcThreads) {
      qs[(i / pad) * LD + d + i % pad] = 0;
    }
  }

  // the block's live K tiles are [kt_lo, kt_hi)
  const int q_last = min(q0 + kTcBQ, s_len) - 1;
  const int n_kt = (t_len + kTcBK - 1) / kTcBK;
  const int kt_hi = causal ? min(n_kt, q_last / kTcBK + 1) : n_kt;
  int kt_lo = 0;
  if (window >= 0) {
    const long long dead = q0 - window;  // keys <= dead are dead for every row here
    if (dead >= 0) kt_lo = t_len - 1 <= dead ? kt_hi : static_cast<int>((dead + 1) / kTcBK);
  }

  // K/V tile kt lives in stage (kt - kt_lo) & 1
  const bool by16 = vec != 0;
  load_tile<kTcBQ>(qb, q0, s_len, d, LD, by16, qs);
  if (kt_lo < kt_hi) {
    load_tile<kTcBK>(kb, kt_lo * kTcBK, t_len, d, LD, by16, kv);
    load_tile<kTcBK>(vb, kt_lo * kTcBK, t_len, d, LD, by16, kv + kTcBK * LD);
  }
  cp_async_commit();

  const int wq0 = q0 + 16 * warp;                 // this warp's rows wq0 .. wq_last
  const int wq_last = min(wq0 + 15, s_len - 1);
  // ldmatrix row addresses: Q as the A operand (rows lane % 16, cols + 8
  // for lanes >= 16); K as B (keys lane % 8 + 8 (lane >= 16), cols + 8 for
  // lanes 8-15 and 24-31); V as B, transposed (keys lane % 16, cols + 8
  // for lanes >= 16)
  const unsigned q_addr = smem_u32(qs + (16 * warp + (lane & 15)) * LD + ((lane >> 4) << 3));
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3);
  const int v_off = (lane & 15) * LD + ((lane >> 4) << 3);

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt is visible to all; every warp is done with tile kt - 1
    if (kt + 1 < kt_hi) {
      uint16_t* nx = kv + (stage ^ 1) * kStage;
      load_tile<kTcBK>(kb, (kt + 1) * kTcBK, t_len, d, LD, by16, nx);
      load_tile<kTcBK>(vb, (kt + 1) * kTcBK, t_len, d, LD, by16, nx + kTcBK * LD);
    }
    cp_async_commit();

    const int k0 = kt * kTcBK;
    const int k_last = min(k0 + kTcBK, t_len) - 1;
    if (wq0 >= s_len || (causal && k0 > wq_last) ||
        (window >= 0 && static_cast<long long>(k_last) <= wq0 - window)) {
      continue;  // no live pair for this warp's rows
    }
    const unsigned ks = smem_u32(kv + stage * kStage);
    const unsigned vs = ks + kTcBK * LD * 2;
    // fragment loads run two steps ahead of the products that use them
    auto k_frag = [&](int step, unsigned (&r)[4]) {  // step = k-step * kNP + key pair
      ldsm_x4(ks + (k_off + (step % kNP) * 16 * LD + (step / kNP) * 16) * 2, r);
    };
    auto v_frag = [&](int step, unsigned (&r)[4]) {  // step = key step * kDPN + column pair
      ldsm_x4_t(vs + (v_off + (step / kDPN) * 16 * LD + (step % kDPN) * 16) * 2, r);
    };

    // S = Q K^T: sc[j] holds keys 8 j .. 8 j + 7 of rows g (0, 1) and g + 8 (2, 3)
    float sc[kTcNT][4];
#pragma unroll
    for (int j = 0; j < kTcNT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    unsigned qa[2][4], kf[3][4];
    ldsm_x4(q_addr, qa[0]);
    k_frag(0, kf[0]);
    k_frag(1, kf[1]);
#pragma unroll
    for (int st = 0; st < kSS; ++st) {
      if (st + 2 < kSS) {
        if ((st + 2) % kNP == 0) ldsm_x4(q_addr + (st + 2) / kNP * 32, qa[(st + 2) / kNP & 1]);
        k_frag(st + 2, kf[(st + 2) % 3]);
      }
      const int np = st % kNP;
      mma_bf16(sc[2 * np], qa[st / kNP & 1], kf[st % 3][0], kf[st % 3][1]);
      mma_bf16(sc[2 * np + 1], qa[st / kNP & 1], kf[st % 3][2], kf[st % 3][3]);
    }
    unsigned vf[3][4];  // the first V fragments load under the softmax
    v_frag(0, vf[0]);
    v_frag(1, vf[1]);

    // scale (base 2), mask where the tile crosses T, the diagonal or the window's edge
    const bool edge = k0 + kTcBK > t_len || (causal && k0 + kTcBK - 1 > wq0) ||
                      (window >= 0 && static_cast<long long>(k0) <= wq_last - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTcNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (edge) {
          const int row = wq0 + g + ((e >> 1) << 3);
          const int col = k0 + 8 * j + 2 * t4 + (e & 1);
          if (col >= t_len) {
            x = -INFINITY;
          } else if ((causal && col > row) ||
                     (window >= 0 && static_cast<long long>(col) <= row - window)) {
            x = kNeg;
          }
        }
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < kTcNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[j][e] - m[e >> 1]);
        sc[j][e] = p;
        l[e >> 1] += p;
      }
    }
    // a factor of exactly 1 for every row of the warp leaves o as it is
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
    }

    // O += P V, P in two bf16 passes (hi, lo); the A fragment of keys
    // 16 kk .. 16 kk + 15 is score tiles 2 kk and 2 kk + 1
    unsigned ah[4], al[4];
#pragma unroll
    for (int st = 0; st < kPS; ++st) {
      const int kk = st / kDPN, dp = st % kDPN;
      if (dp == 0) {
        split_p(sc[2 * kk][0], sc[2 * kk][1], ah[0], al[0]);
        split_p(sc[2 * kk][2], sc[2 * kk][3], ah[1], al[1]);
        split_p(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ah[2], al[2]);
        split_p(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ah[3], al[3]);
      }
      if (st + 2 < kPS) v_frag(st + 2, vf[(st + 2) % 3]);
      const unsigned (&b)[4] = vf[st % 3];
      mma_bf16(o[2 * dp], ah, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], ah, b[2], b[3]);
      mma_bf16(o[2 * dp], al, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], al, b[2], b[3]);
    }
  }
  cp_async_wait_all();  // no copy outlives the block

  OUT* ob = out + bh * s_len * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = wq0 + g + 8 * h;
    if (row >= s_len) continue;
    const float den = fmaxf(l[h], 1e-30f);
    OUT* orow = ob + static_cast<long long>(row) * d;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < d) orow[col] = to_out(o[j][2 * h] / den, ob);
      if (col + 1 < d) orow[col + 1] = to_out(o[j][2 * h + 1] / den, ob);
    }
  }
}

template <typename OUT, int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, int bh, int s,
                        int t, int d, int causal, long long window, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(kTcBQ + 4 * kTcBK) * (DP + 8) * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<OUT, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale_log2 = static_cast<float>(pow(static_cast<double>(d), -0.5) *
                                              1.4426950408889634);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  const int vec = d % 8 == 0 && bases % 16 == 0;
  const unsigned grid = static_cast<unsigned>((s + kTcBQ - 1) / kTcBQ) * bh;
  flash_fwd_bf16<OUT, DP><<<grid, kTcThreads, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<OUT*>(out), s, t, d, bh, causal, window,
      scale_log2, vec);
  return cudaGetLastError();
}

template <typename OUT>
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* out, int bh, int s,
                          int t, int d, int causal, long long window, cudaStream_t st) {
  if (d <= 16) return launch_bf16<OUT, 16>(q, k, v, out, bh, s, t, d, causal, window, st);
  if (d <= 32) return launch_bf16<OUT, 32>(q, k, v, out, bh, s, t, d, causal, window, st);
  if (d <= 64) return launch_bf16<OUT, 64>(q, k, v, out, bh, s, t, d, causal, window, st);
  if (d <= 128) return launch_bf16<OUT, 128>(q, k, v, out, bh, s, t, d, causal, window, st);
  return launch_bf16<OUT, 256>(q, k, v, out, bh, s, t, d, causal, window, st);
}

// ------------------------------------------------- fp32: CUDA cores
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // a 16 x 16 grid of threads
constexpr int kRows = kBQ / 16;  // rows per thread: ty + 16 i
constexpr int kKeys = kBK / 16;  // keys per thread: tx + 16 j
constexpr int kLdq = kBQ + 1;    // transposed tiles: +1 keeps the stores
constexpr int kLdk = kBK + 1;    // of a warp's 32 columns in 32 banks
constexpr int kLdp = kBK + 16;   // the two half-warps' rows 16 banks apart

__device__ __forceinline__ void load_rows(const float* __restrict__ src, int row0, int n_rows,
                                          int d, int warp, int lane, float* dst, int ld,
                                          bool transpose) {
  for (int r = warp; r < kBK; r += kThreads / 32) {
    const int i = row0 + r;
    for (int c = lane; c < d; c += 32) {
      const float x = i < n_rows ? src[static_cast<long long>(i) * d + c] : 0.f;
      if (transpose) {
        dst[c * ld + r] = x;
      } else {
        dst[r * ld + c] = x;
      }
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out, int s_len, int t_len,
                   int d, int causal, long long window, float scale) {
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
  const float* qb = q + bh * s_len * d;
  const float* kb = k + bh * t_len * d;
  const float* vb = v + bh * t_len * d;

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

  float* ob = out + bh * s_len * d;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[static_cast<long long>(row) * d + col] = acc[i][c] / den;
    }
  }
}

template <int NC>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* out, int bh, int s,
                        int t, int d, int causal, long long window, cudaStream_t st) {
  const size_t smem =
      (static_cast<size_t>(d) * (kLdq + kLdk) + kBK * 16 * NC + kBQ * kLdp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fp32<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(pow(static_cast<double>(d), -0.5));
  const dim3 grid((s + kBQ - 1) / kBQ, bh);
  flash_fwd_fp32<NC><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), s, t, d, causal, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_fp32(const void* q, const void* k, const void* v, void* out, int bh, int s,
                          int t, int d, int causal, long long window, cudaStream_t st) {
  if (d <= 16) return launch_fp32<1>(q, k, v, out, bh, s, t, d, causal, window, st);
  if (d <= 32) return launch_fp32<2>(q, k, v, out, bh, s, t, d, causal, window, st);
  if (d <= 64) return launch_fp32<4>(q, k, v, out, bh, s, t, d, causal, window, st);
  if (d <= 128) return launch_fp32<8>(q, k, v, out, bh, s, t, d, causal, window, st);
  return launch_fp32<16>(q, k, v, out, bh, s, t, d, causal, window, st);
}

}  // namespace

// dtype: 0 fp32 in and out; 1 bf16 (uint16 bits) in and out; 2 bf16 in,
// fp32 out (the tensor-core kernel before its output rounding; a check
// only, not the public entry's).  q [bh, s, d], k/v [bh, t, d], out
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
      return static_cast<int>(dispatch_fp32(q, k, v, out, bh, s, t, d, causal, window, st));
    case 1:
      return static_cast<int>(
          dispatch_bf16<uint16_t>(q, k, v, out, bh, s, t, d, causal, window, st));
    case 2:
      return static_cast<int>(
          dispatch_bf16<float>(q, k, v, out, bh, s, t, d, causal, window, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
