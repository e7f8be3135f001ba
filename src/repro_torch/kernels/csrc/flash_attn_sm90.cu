// Flash attention (forward), bf16, for Hopper (sm_90a): TMA loads into a
// shared-memory ring, wgmma from two ping-ponged consumer warpgroups.
// Replaces the Pallas kernel repro/kernels/flash_attn.py::flash_attention
// (body _kernel) for bf16 inputs whose head dim is a multiple of 8 and whose
// base pointers are 16-byte aligned (what TMA takes: 16-byte row strides and
// bases); repro_torch.kernels.flash_attn._route picks it by shape, and
// csrc/flash_attn.cu's mma.sync kernel takes the other bf16 shapes.  Its
// plain version is repro_torch.kernels.flash_attn.flash_attention_plain (the
// reference's kernels/ref.py::mha_ref).
//
// What it computes is flash_fwd_bf16's (csrc/flash_attn.cu), under the same
// numeric contract: q.k of bf16 values in fp32; softmax in base 2 on scores
// pre-scaled by D^-0.5 * log2(e), masked to -1e30, keys past T at -inf; p
// carried as p_hi = bf16(p) and p_lo = bf16(p - p_hi), each multiplied by
// bf16 v with fp32 accumulation, while l sums the fp32 p; output
// acc / max(l, 1e-30) in bf16 (or fp32 for the private wide check).
//
// Bound: operations on the tensor cores, 3 x 2 D flops a live (query, key)
// pair (q.k once, p.v twice) at 989 TFLOP/s; beside it, one exponential a
// pair at about 3.9e12 a second (the MUFU unit), which at D = 64 takes two
// thirds of the products' time and at D = 256 a sixth.
//
// Design.  A block of three warpgroups takes 128 query rows of one head;
// blocks are ordered so the heaviest causal query tiles of every head start
// first.  Warpgroup 2 is the producer: it drops to 40 registers
// (setmaxnreg.dec) and one thread issues every load as a TMA copy of a
// 64 x 64 box (128 B a row, 128-byte swizzle) through 3-D tensor maps
// [BH, S|T, D], so a box that crosses S, T or D reads zeros, never the next
// head's rows: Q once, then K and V tiles through a ring of stages, each with
// a full barrier for K, one for V and an empty barrier the consumers release.
// Warpgroups 0 and 1 are the consumers (setmaxnreg.inc to 232), 64 query
// rows each: S = Q K^T is wgmma.m64nBKk16 with both operands in shared memory
// (K-major); O += P_hi V and O += P_lo V take P from registers (the score
// accumulator's layout is the A fragment's) and V through a transposed
// (MN-major) descriptor.  O (64 x D fp32 a warpgroup) stays in registers and
// is rescaled only when a row's max moved.  Tiles: BK = 64 keys at D = 256
// (Q 64 KB and two 64 KB stages), BK = 128 at D <= 128 with as many stages as
// fit; D rounds up to 64, 128 or 256 and the map's zero fill supplies the
// padding columns.  The softmax runs under the tensor cores twice over: the
// two consumers take turns on two named barriers to issue their products
// (one warpgroup's softmax runs under the other's wgmma), and within a
// warpgroup the next tile's Q K^T and the current tile's P V are issued
// before the next tile's softmax, which waits only for the first.  The
// exponential is ex2.approx.f32 (MUFU.EX2 with its scaling for denormal
// results; not .ftz: the build keeps denormals), within ~2 ulp of fp32;
// exp2f compiles to the same sequence under these flags.  Tiles wholly dead
// for the block are skipped; the mask is decided once a tile and applied by
// selects only on tiles that cross T, the diagonal or the window's edge (a
// 64-bit width: gemma3's 2^24 "no window"), so a tile's elements run without
// branches.  Rows past S and columns past D are not written.  Every
// descriptor is a tile's base plus a constant added where its wgmma issues,
// and every mbarrier wait is a PTX loop: either in C++ (held descriptors, a
// clock64() loop) left ptxas short of registers for the wgmma pipelines, so
// it spilled and serialized them.
//
// Measured (chip_smoke.py, phases 7, 11 and 12, on an H100 80GB HBM3
// at 700 W): gemma3-1b's global layer (BH 8, S 4,096, D 256, causal) in 56 %
// of the bound, against 24 % for the mma.sync kernel, and the D = 64 shapes
// in 36-41 %.  What still holds it back: at D = 64 the softmax, not the
// tensor cores (a tile's exponentials, the p_hi/p_lo split and the row sums
// take as long as its three products, and two consumer warpgroups of 232
// registers are all an SM holds, so little else hides their latency);
// scaled_dot_product_attention is 1.4-1.6x faster there, with one bf16 pass
// for p where this kernel carries p in two.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"      // barriers, copies, wgmma fences, descriptors, the online softmax
#include "tree_sum.cuh"  // repro_cuda_error_string

namespace {

using namespace sm90;

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // warpgroups 0, 1 consume; 2 produces
constexpr int kBQ = 64 * kConsumers;              // query rows a block, 64 a consumer
constexpr int kBox = 64;                          // a TMA box: 64 columns (128 B) x up to 64 rows
constexpr int kBarBytes = 256;


// Shared memory of the DP instantiation: Q [chunk][kBQ][128 B], then the
// stages, each K [chunk][BK][128 B] and V [chunk][BK][128 B], then the
// barriers; a chunk is 64 columns.  Every tile starts on 1,024 bytes (the
// 128-byte swizzle repeats every 8 rows).
template <int DP>
struct Tiles {
  static constexpr int BK = DP == 256 ? 64 : 128;
  static constexpr int kChunks = DP / kBox;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kKVBytes = BK * DP * 2;  // one K (or V) tile
  static constexpr int kStages = (kSmemLimit - 1024 - kBarBytes - kQBytes) / (2 * kKVBytes);
  static constexpr int kSmem = 1024 + kQBytes + kStages * 2 * kKVBytes + kBarBytes;
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "two stages must fit");
  static_assert((1 + 3 * kStages) * 8 <= kBarBytes, "the barriers must fit");
};

// d (64 x 64 fp32) += A (64 x 16, K-major, shared) * B (64 x 16, K-major, shared);
// scale_d 0 ignores d's old values
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128 fp32) += A (64 x 16, K-major, shared) * B (128 x 16, K-major, shared);
// scale_d 0 ignores d's old values
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers) * B (16 x 64, MN-major, shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 fp32) += A (64 x 16 bf16, registers) * B (16 x 128, MN-major, shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 256 fp32) += A (64 x 16 bf16, registers) * B (16 x 256, MN-major, shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P_hi V + P_lo V: P from registers (A fragments of 16 keys each), V
// [BK keys][DP columns] in shared memory at v_tile, MN-major: 16 keys are 2
// groups of 8 rows, 1,024 bytes apart; 64-column chunks BK rows apart
template <int BK, int NO, int KS>
__device__ __forceinline__ void pv_products(float (&o)[NO], const uint32_t (&ph)[KS][4],
                                            const uint32_t (&pl)[KS][4], uint32_t v_tile) {
  const uint64_t b0 = desc(v_tile, BK * kRowBytes, 8 * kRowBytes);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t b = desc_at(b0, kk * 16 * kRowBytes);
    wgmma_rs(o, ph[kk], b);
    wgmma_rs(o, pl[kk], b);
  }
}

// ------------------------------------------------------------ arithmetic
// (p0, p1) -> hi = bf16(p), lo = bf16(p - hi) (the subtraction is exact),
// each a packed pair with p0 in the low half
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// float -> bfloat16 bits, round to nearest even; NaN -> 0x7fc0 (torch's cast)
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  const unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(uint16_t* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) =
      static_cast<uint32_t>(bf16_bits(a)) | (static_cast<uint32_t>(bf16_bits(b)) << 16);
}

// S (64 x BK fp32) = Q (64 rows of the warpgroup at q_wg) K^T (BK keys at
// k_tile), both K-major: a step takes 16 columns (32 bytes) of a chunk
template <int BK, int DP, int NS>
__device__ __forceinline__ void qk_products(float (&sc)[NS], uint32_t q_wg, uint32_t k_tile) {
  const uint64_t a0 = desc(q_wg, 16, 8 * kRowBytes), b0 = desc(k_tile, 16, 8 * kRowBytes);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    constexpr int kStep = 32;  // 16 columns within a chunk
    wgmma_ss(sc, desc_at(a0, (kk / 4) * kBQ * kRowBytes + (kk % 4) * kStep),
             desc_at(b0, (kk / 4) * BK * kRowBytes + (kk % 4) * kStep), kk > 0);
  }
}

// p -> the A fragments of P V: keys 16 kk .. 16 kk + 15 are score tiles 2 kk
// and 2 kk + 1, as hi = bf16(p) and lo = bf16(p - hi)
template <int NS, int KS>
__device__ __forceinline__ void split_all(const float (&sc)[NS], uint32_t (&ph)[KS][4],
                                          uint32_t (&pl)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      split_p(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r], pl[kk][r]);
    }
  }
}

// ------------------------------------------------------------ the kernel
template <typename OUT, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, OUT* __restrict__ out, int s_len,
                   int t_len, int d, int n_bh, int causal, long long window, float scale_log2) {
  using T = Tiles<DP>;
  constexpr int BK = T::BK;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                   // Q [chunk][kBQ][128 B]
  const uint32_t kv_s = base + T::kQBytes;     // stage s at kv_s + 2 s kKVBytes: K, then V
  const uint32_t bar_s = kv_s + kStages * 2 * T::kKVBytes;
  // barriers: Q full; K full, V full and stage empty of each stage
  const uint32_t q_full = bar_s;
  auto k_full = [&](int s) { return bar_s + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar_s + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bar_s + 8u * (1 + 2 * kStages + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // block b takes query tile n_qt - 1 - b / n_bh of head b % n_bh: the
  // heaviest causal tiles of every head start first
  const int n_qt = (s_len + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x / n_bh)) * kBQ;
  const int bh = static_cast<int>(blockIdx.x % n_bh);

  // the block's live K tiles are [kt_lo, kt_lo + n_tiles)
  const int q_last = min(q0 + kBQ, s_len) - 1;
  const int n_kt = (t_len + BK - 1) / BK;
  const int kt_hi = causal ? min(n_kt, q_last / BK + 1) : n_kt;
  int kt_lo = 0;
  if (window >= 0) {
    const long long dead = q0 - window;  // keys <= dead are dead for every row here
    if (dead >= 0) kt_lo = t_len - 1 <= dead ? kt_hi : static_cast<int>((dead + 1) / BK);
  }
  const int n_tiles = max(kt_hi - kt_lo, 0);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---------------------------------------------------- the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 4 * kConsumers && lane == 0 && n_tiles > 0) {
      mbar_expect(q_full, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c) {
#pragma unroll
        for (int h = 0; h < kBQ / kBox; ++h) {
          tma_box(q_s + (c * kBQ + h * kBox) * kRowBytes, &map_q, q_full, c * kBox,
                  q0 + h * kBox, bh);
        }
      }
      int stage = 0;
      unsigned phase = 0;
      for (int n = 0; n < n_tiles; ++n) {
        const int k0 = (kt_lo + n) * BK;
        const uint32_t k_dst = kv_s + stage * 2 * T::kKVBytes, v_dst = k_dst + T::kKVBytes;
        mbar_wait(empty(stage), phase ^ 1u);  // the first round passes at once
        mbar_expect(k_full(stage), T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
#pragma unroll
          for (int b = 0; b < BK / kBox; ++b) {
            tma_box(k_dst + (c * BK + b * kBox) * kRowBytes, &map_k, k_full(stage), c * kBox,
                    k0 + b * kBox, bh);
          }
        }
        mbar_expect(v_full(stage), T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
#pragma unroll
          for (int b = 0; b < BK / kBox; ++b) {
            tma_box(v_dst + (c * BK + b * kBox) * kRowBytes, &map_v, v_full(stage), c * kBox,
                    k0 + b * kBox, bh);
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
  } else {
    // ---------------------------------------------------- the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    constexpr int kS = BK / 2;    // score registers a thread (m64nBK)
    constexpr int kO = DP / 2;    // accumulator registers a thread (m64nDP)
    constexpr int kKS = BK / 16;  // key steps of p.v
    const int wg = warp / 4;  // 0 or 1
    const int t4 = lane & 3;
    const int wq0 = q0 + 64 * wg;
    const int row0 = wq0 + 16 * (warp & 3) + (lane >> 2);  // this thread's rows: row0, row0 + 8
    const int my_turn = 1 + wg, their_turn = 2 - wg;
    const uint32_t q_wg = q_s + 64 * wg * kRowBytes;
    const Mask mask{t_len, causal, window, wq0, row0, t4, scale_log2};

    float o[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.f;
    float sc[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) sc[i] = 0.f;
    uint32_t ph[kKS][4], pl[kKS][4];
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, corr[2];

    auto k_tile = [&](int s) { return kv_s + s * 2 * T::kKVBytes; };
    auto v_tile = [&](int s) { return k_tile(s) + T::kKVBytes; };

    if (n_tiles > 0) {
      if (wg == 1) turn_pass(1);  // the first turn is warpgroup 0's
      mbar_wait(q_full, 0);
      // tile 0: S = Q K^T alone
      mbar_wait(k_full(0), 0);
      turn_wait(my_turn);
      keep(sc);
      wg_fence();
      qk_products<BK, DP>(sc, q_wg, k_tile(0));
      wg_commit();
      turn_pass(their_turn);
      wg_wait<0>();
      keep(sc);
      online_softmax(sc, m, l, corr, kt_lo * BK, mask);
      split_all(sc, ph, pl);
      int stage = 1, prev = 0;  // tile n lives in stage n % kStages
      unsigned phase = 0, prev_phase = 0;
      for (int n = 1; n < n_tiles; ++n) {
        mbar_wait(k_full(stage), phase);
        mbar_wait(v_full(prev), prev_phase);
        turn_wait(my_turn);
        // this warpgroup's turn: S = Q K^T of tile n, then P V of tile n - 1;
        // the softmax of tile n waits for the first only
        keep(sc);
        keep(o);
        keep(ph);
        keep(pl);
        wg_fence();
        qk_products<BK, DP>(sc, q_wg, k_tile(stage));
        wg_commit();
        pv_products<BK>(o, ph, pl, v_tile(prev));
        wg_commit();
        turn_pass(their_turn);
        wg_wait<1>();
        keep(sc);
        online_softmax(sc, m, l, corr, (kt_lo + n) * BK, mask);
        wg_wait<0>();  // P V of tile n - 1 is done: its stage is free
        keep(o);
        keep(ph);
        keep(pl);
        if (lane == 0) mbar_arrive(empty(prev));
        // a factor of exactly 1 for every row of the warp leaves o as it is
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
          for (int i = 0; i < kO; ++i) o[i] *= corr[(i >> 1) & 1];
        }
        split_all(sc, ph, pl);
        prev = stage;
        prev_phase = phase;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
      // the last tile's P V: warpgroup 1's last turn passes to no one
      mbar_wait(v_full(prev), prev_phase);
      turn_wait(my_turn);
      keep(o);
      keep(ph);
      keep(pl);
      wg_fence();
      pv_products<BK>(o, ph, pl, v_tile(prev));
      wg_commit();
      if (wg == 0) turn_pass(their_turn);
      wg_wait<0>();
      keep(o);
    }

    OUT* ob = out + static_cast<long long>(bh) * s_len * d;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = row0 + 8 * h;
      if (row >= s_len) continue;
      const float den = fmaxf(l[h], 1e-30f);
      OUT* orow = ob + static_cast<long long>(row) * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t4;  // d is even: both columns or neither
        if (col < d) store2(orow + col, o[4 * j + 2 * h] / den, o[4 * j + 2 * h + 1] / den);
      }
    }
  }
}

// ------------------------------------------------------------ host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// [n_bh, rows, d] bf16 as a 3-D map of 64 x 64 boxes, 128-byte swizzle;
// out-of-bounds elements read as zeros
bool encode(EncodeTiled enc, CUtensorMap* map, const void* base, int n_bh, int rows, int d) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n_bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {kBox, kBox, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OUT, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int s, int t,
                   int d, int causal, long long window, cudaStream_t st) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!encode(enc, &mq, q, bh, s, d) || !encode(enc, &mk, k, bh, t, d) ||
      !encode(enc, &mv, v, bh, t, d)) {
    return cudaErrorInvalidValue;
  }
  const int smem = Tiles<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90<OUT, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = static_cast<float>(pow(static_cast<double>(d), -0.5) *
                                              1.4426950408889634);
  const unsigned grid = static_cast<unsigned>((s + kBQ - 1) / kBQ) * static_cast<unsigned>(bh);
  flash_fwd_sm90<OUT, DP><<<grid, kThreads, smem, st>>>(mq, mk, mv, static_cast<OUT*>(out), s, t,
                                                        d, bh, causal, window, scale_log2);
  return cudaGetLastError();
}

template <typename OUT>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int bh, int s, int t,
                     int d, int causal, long long window, cudaStream_t st) {
  if (d <= 64) return launch<OUT, 64>(q, k, v, out, bh, s, t, d, causal, window, st);
  if (d <= 128) return launch<OUT, 128>(q, k, v, out, bh, s, t, d, causal, window, st);
  return launch<OUT, 256>(q, k, v, out, bh, s, t, d, causal, window, st);
}

}  // namespace

// bf16 q [bh, s, d], k/v [bh, t, d] -> out [bh, s, d], contiguous; out is
// bf16 (uint16 bits), or fp32 when out_fp32 (the kernel before its output
// rounding; a check only).  d a multiple of 8 up to 256 and every base
// 16-byte aligned (the shapes TMA takes; the caller routes the others to
// csrc/flash_attn.cu).  causal: 0/1; window < 0: no window.  Returns
// cudaGetLastError(), cudaErrorInvalidValue for a shape it does not take,
// or cudaErrorNotSupported without the driver's tensor-map encoder.
extern "C" int repro_flash_attention_sm90(int out_fp32, const void* q, const void* k,
                                          const void* v, void* out, int bh, int s, int t, int d,
                                          int causal, long long window, void* stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (bh < 1 || s < 1 || t < 1 || d < 8 || d > 256 || d % 8 != 0 || bases % 16 != 0 ||
      static_cast<long long>((s + kBQ - 1) / kBQ) * bh > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_fp32) {
    return static_cast<int>(dispatch<float>(q, k, v, out, bh, s, t, d, causal, window, st));
  }
  return static_cast<int>(dispatch<uint16_t>(q, k, v, out, bh, s, t, d, causal, window, st));
}
