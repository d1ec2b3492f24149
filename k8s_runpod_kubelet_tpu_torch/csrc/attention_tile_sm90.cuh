// The attention tile body both bf16 attention kernels of this package run on
// Hopper's tensor cores (sm_90a): the flash forward (flash_attention.cu) and
// paged multi-token attention (paged_attention_multi.cu). Each of those
// sources states the TPU kernel it replaces and gives this body its rows
// (which query rows a block owns, and the key range each row sees) and its
// key rows (contiguous for flash, gathered page by page for paged). The
// flash backward kernels (flash_attention.cu), the int8-page paged kernel
// (paged_attention_multi_quant.cu), the paged MLA latent kernels
// (paged_attention_mla.cuh) and int4_matmul.cu build on its primitives:
// start_scores for S = Q K^T-shaped products, split_p for any f32 operand
// (P, dS) and start_rs for the products that take it, the MmaSS/MmaRS
// wgmma shapes, the swizzled layout and the cp.async helpers.
//
// The tile: a warpgroup (4 warps, 128 threads) owns 64 query rows; a block
// of WG warpgroups shares each staged K/V tile of BN keys.
//   S = Q K^T   wgmma m64nBNk16, bf16 in, f32 accumulate, Q and K read from
//               128-byte-swizzled shared memory through wgmma descriptors;
//               products of bf16 values are exact in f32, so no split here.
//   scale       applied to the f32 scores after the product (the reference
//               scales q in f32; D^-1/2 is not a power of two, so scaling q
//               in bf16 would round it), then the soft cap cap*tanh(s/cap),
//               then the mask.
//   softmax     online (running max, sum, rescale) in f32 on the accumulator
//               fragments, in log2 units (exp2). Masked scores are -inf, so
//               their probabilities are exactly 0 whatever the running max:
//               a row that sees no key keeps o = 0, l = 0 (it never takes
//               exp(-1e30 - (-1e30)) = 1).
//   O += P V    P split in registers into bf16 hi = bf16(P) and lo =
//               bf16(P - hi), run as two wgmma m64nDk16 with V read from
//               shared memory as the MN-major (transposed) B operand. P
//               rounded to bf16 alone would put the output some 14x outside
//               the chip check's 1.3-ulp tolerance at the training shape
//               (the reference computes p.v in f32); hi + lo carries P to
//               ~2^-17 relative, 1.5x the function's tensor work.
//   pipeline    step t starts S(t) and P(t-1) V(t-1) together and runs
//               the softmax of S(t) on the CUDA cores while P V runs on the
//               tensor cores. Every thread starts 16-byte cp.async copies
//               of tile t + 1 meanwhile (rows past a block's range are
//               zero-filled, never read) into a ring of two K and three V
//               stages (V(t-1) is still read while tile t + 1 lands).
//
// Shared memory layout (the canonical SWIZZLE_128B layout wgmma reads): a
// tile of R rows x C bf16 columns is C/64 column blocks of R rows x 128
// bytes, 1024-byte aligned; 16-byte chunk c of row r sits at chunk
// c ^ (r % 8). Q and K are K-major operands (a row is an M or N index, its
// columns the reduced dimension; SBO = 1024, the next 8 rows); V is the
// same bytes read MN-major (a row is a key, the reduced dimension; LBO =
// R * 128, the next 64 columns; SBO = 1024, the next 8 keys).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile90 {

constexpr int kWarpgroup = 128;       // threads of a warpgroup
constexpr int kRows = 64;             // query rows a warpgroup owns
constexpr float kNegInf = -1e30f;     // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// a masked score: exp2 of it less any finite max is exactly 0
constexpr float kMinusInf = -__builtin_huge_valf();

// ------------------------------------------------------------ primitives --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row r in a swizzled tile of `rows`
__device__ __forceinline__ uint32_t swz(int rows, int r, int chunk) {
  return uint32_t((chunk >> 3) * rows * 128 + r * 128 +
                  (((chunk & 7) ^ (r & 7)) << 4));
}

// 16 bytes global -> shared; `valid` false writes zeros and reads nothing
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared; `valid` false writes zeros and reads nothing
__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// until at most N committed groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's shared-memory writes made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);  // 128B swizzle
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are still running
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of wgmma registers across
// the asynchronous instructions
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x on the special-function unit, subnormal results flushed to 0 (a
// probability below 2^-126 of the row's largest); 2^-inf = 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, d += A B (d = A B where
// accumulate is 0). MmaSS: A and B from shared memory, both K-major
// (scores). MmaRS: A from registers (the m64k16 fragment: register (half * 2
// + i) holds the pair of row i in 8-column block half, as split_p lays it
// out); TB is B's layout: 1 MN-major (a row of the B tile is the reduced
// dimension: V in P V), 0 K-major (a row is an N index, its columns the
// reduced dimension: h in int4_matmul, the rope keys of the MLA body).
template <int N>
struct MmaSS;
template <int N, int TB = 1>
struct MmaRS;

template <>
struct MmaSS<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct MmaSS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <int TB>
struct MmaRS<16, TB> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
          "n"(TB));
  }
};

template <int TB>
struct MmaRS<32, TB> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
          "n"(TB));
  }
};

template <int TB>
struct MmaRS<64, TB> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
          "n"(TB));
  }
};

template <int TB>
struct MmaRS<128, TB> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
          "n"(TB));
  }
};

// m64n192k16: the products of the flash kernels at D = 192 (MLA's q/k
// width, head_dim 128 + rope 64) whose N is the head dimension: P V, dS K,
// P^T dO and dS^T Q, one 96-register f32 fragment over three 64-column
// swizzle atoms of B
template <int TB>
struct MmaRS<192, TB> {
  static __device__ __forceinline__ void run(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
          "n"(TB));
  }
};

template <int TB>
struct MmaRS<256, TB> {
  static __device__ __forceinline__ void run(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
          "n"(TB));
  }
};

// ------------------------------------------------------------- the tile --

// One thread's share of its warpgroup's 64 rows, in the m64 accumulator
// fragment layout: rows row(0) and row(0) + 8, two adjacent columns in each
// 8-column block.
template <int D>
struct Rows {
  float o[D / 2];    // the m64nD output accumulator fragment
  float m[2];        // running max of each row (log2 units), row-uniform
  float l[2];        // running sum over this thread's columns
  int lo[2], hi[2];  // the keys each row sees: lo <= key <= hi (hi < 0: none)

  static __device__ __forceinline__ int row(int i) {
    const int t = threadIdx.x % kWarpgroup;
    return (t / 32) * 16 + (t % 32) / 4 + 8 * i;
  }
  static __device__ __forceinline__ int col(int n8, int j) {
    return n8 * 8 + (threadIdx.x % 4) * 2 + j;
  }
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
  }
};

// S = Q K^T of one staged K tile for the warpgroup's 64 rows (Q at q_s
// inside a swizzled tile of q_rows rows), started and not waited for.
template <int D, int BN>
__device__ __forceinline__ void start_scores(float (&s)[BN / 2], uint32_t q_s,
                                             int q_rows, uint32_t k_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    MmaSS<BN>::run(
        s, desc(q_s + (kk / 4) * q_rows * 128 + (kk % 4) * 32, 16, 1024),
        desc(k_s + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
}

// acc += A B over one staged tile of BN rows: A (64 x BN, f32) as its bf16
// hi and lo fragments, B the tile's BN rows x N columns read MN-major (its
// rows are the reduced dimension): started and not waited for.
template <int N, int BN>
__device__ __forceinline__ void start_rs(float (&acc)[N / 2],
                                         const uint32_t (&ah)[BN / 16][4],
                                         const uint32_t (&al)[BN / 16][4],
                                         uint32_t b_s) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = desc(b_s + kk * 16 * 128, BN * 128, 1024);
    MmaRS<N>::run(acc, ah[kk], db);
    MmaRS<N>::run(acc, al[kk], db);
  }
}

// O += P V of one staged V tile, P as its bf16 hi and lo A fragments:
// started and not waited for.
template <int D, int BN>
__device__ __forceinline__ void start_pv(Rows<D>& st,
                                         const uint32_t (&ph)[BN / 16][4],
                                         const uint32_t (&pl)[BN / 16][4],
                                         uint32_t v_s) {
  start_rs<D, BN>(st.o, ph, pl, v_s);
}

// The tile's scores s (keys key0 ..) to probabilities in place: scale, soft
// cap, mask (skipped when every key of the tile is visible to both rows),
// the new running max; s becomes P = exp2(s - m), exactly 0 where masked.
// Returns each row's correction exp2(m_old - m_new) and this thread's sum
// of its P; st.o and st.l are left to the caller.
template <int D, int BN>
__device__ __forceinline__ void softmax(Rows<D>& st, float (&s)[BN / 2],
                                        int key0, float scale,
                                        float soft_cap, float (&corr)[2],
                                        float (&sum)[2]) {
  const bool capped = soft_cap > 0.f;
  const float mul = capped ? scale / soft_cap : scale * kLog2e;
  const float post = soft_cap * kLog2e;
  const bool whole = key0 >= st.lo[0] && key0 >= st.lo[1] &&
                     key0 + BN - 1 <= st.hi[0] && key0 + BN - 1 <= st.hi[1];
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int n8 = 0; n8 < BN / 8; ++n8)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[n8 * 4 + i * 2 + j] * mul;
        if (capped) x = post * tanhf(x);
        if (!whole) {
          const int key = key0 + Rows<D>::col(n8, j);
          if (key < st.lo[i] || key > st.hi[i]) x = kMinusInf;
        }
        s[n8 * 4 + i * 2 + j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    corr[i] = exp2_ftz(st.m[i] - mx[i]);
    st.m[i] = mx[i];
    sum[i] = 0.f;
  }
#pragma unroll
  for (int n8 = 0; n8 < BN / 8; ++n8)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = exp2_ftz(s[n8 * 4 + i * 2 + j] - st.m[i]);
        s[n8 * 4 + i * 2 + j] = p;
        sum[i] += p;
      }
}

// P (f32, the accumulator layout) to bf16 hi = bf16(P) and lo = bf16(P -
// hi) A fragments: k16 slice kk holds columns 16 kk .. 16 kk + 15, register
// (half * 2 + i) the pair of row i in 8-column block 2 kk + half.
template <int BN>
__device__ __forceinline__ void split_p(const float (&p)[BN / 2],
                                        uint32_t (&ph)[BN / 16][4],
                                        uint32_t (&pl)[BN / 16][4]) {
#pragma unroll
  for (int n8 = 0; n8 < BN / 8; ++n8)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float p0 = p[n8 * 4 + i * 2], p1 = p[n8 * 4 + i * 2 + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      ph[n8 / 2][(n8 % 2) * 2 + i] = bf16x2_bits(hi);
      pl[n8 / 2][(n8 % 2) * 2 + i] =
          bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
    }
}

// ------------------------------------------------------------ the block --

// Rows [0, R) of a D-wide bf16 tile into the swizzled layout at dst by
// 16-byte cp.async: src(r) is the element offset of row r in base, or -1
// for a row that reads as zeros (and reads nothing).
template <int R, int D, int THREADS, class Src>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          Src src) {
  constexpr int CH = D / 8;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < R * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    const long long off = src(r);
    cp16(dst + swz(R, r, c), base + (off >= 0 ? off + c * 8 : 0), off >= 0);
  }
}

// The K and V rows of one tile (the same offsets in both)
template <int R, int D, int THREADS, class Src>
__device__ __forceinline__ void load_kv(uint32_t k_dst, uint32_t v_dst,
                                        const __nv_bfloat16* k,
                                        const __nv_bfloat16* v, Src src) {
  constexpr int CH = D / 8;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < R * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    const long long off = src(r);
    const long long e = off >= 0 ? off + c * 8 : 0;
    cp16(k_dst + swz(R, r, c), k + e, off >= 0);
    cp16(v_dst + swz(R, r, c), v + e, off >= 0);
  }
}

// Dynamic shared memory of a block: its Q tile, two K stages and three V
// stages (V of tile t - 1 is read while tile t + 1 lands), and 1 KB to align
// the base to the swizzle's 1024 bytes.
template <int D, int BN, int WG>
constexpr size_t smem_bytes() {
  return 1024 + size_t(kRows) * WG * D * 2 + 5 * size_t(BN) * D * 2;
}

// The block's walk: its BM = 64 WG query rows (q_src(r): offset of row r in
// q, or -1) against n_tiles tiles of BN keys from key_begin (k_src(key):
// offset of that key's row in k and v, or -1 past the block's range), each
// warpgroup folding every tile into its Rows. Step t starts S(t) = Q K(t)^T
// and O += P(t-1) V(t-1) together, runs the softmax of S(t) while the
// second product is on the tensor cores, then rescales O; the copies of
// tile t + 1 land meanwhile.
template <int D, int BN, int WG, class QSrc, class KSrc>
__device__ __forceinline__ void attend(Rows<D>& st, unsigned char* smem,
                                       const __nv_bfloat16* q, QSrc q_src,
                                       const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, KSrc k_src,
                                       int key_begin, int n_tiles,
                                       float scale, float soft_cap) {
  constexpr int BM = kRows * WG, THREADS = kWarpgroup * WG;
  constexpr uint32_t kTile = BN * D * 2;  // bytes of one K or V tile
  if (n_tiles <= 0) return;
  const uint32_t q_s = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + BM * D * 2;  // K stages t % 2
  const uint32_t v_s = k_s + 2 * kTile;   // V stages t % 3
  load_rows<BM, D, THREADS>(q_s, q, q_src);
  load_kv<BN, D, THREADS>(k_s, v_s, k, v,
                          [&](int r) { return k_src(key_begin + r); });
  cp_commit();
  const uint32_t q_wg = q_s + (threadIdx.x / kWarpgroup) * kRows * 128;
  float s[BN / 2];
  uint32_t ph[BN / 16][4], pl[BN / 16][4];
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait_all();       // tile t's copies (started one step ago) landed
    fence_async_smem();  // ... and are visible to wgmma
    __syncthreads();     // every thread's; every warpgroup is past t - 1
    if (t + 1 < n_tiles) {
      const int key0 = key_begin + (t + 1) * BN;
      load_kv<BN, D, THREADS>(k_s + ((t + 1) & 1) * kTile,
                              v_s + ((t + 1) % 3) * kTile, k, v,
                              [&](int r) { return k_src(key0 + r); });
    }
    cp_commit();

#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    reg_fence(s);
    reg_fence(st.o);
    wg_fence();
    start_scores<D, BN>(s, q_wg, BM, k_s + (t & 1) * kTile);
    wg_commit();
    if (t > 0) {
      start_pv<D, BN>(st, ph, pl, v_s + ((t - 1) % 3) * kTile);
      wg_commit();
      wg_wait<1>();  // the scores; P(t-1) V(t-1) may still run
    } else {
      wg_wait<0>();
    }
    reg_fence(s);
    float corr[2], sum[2];
    softmax<D, BN>(st, s, key_begin + t * BN, scale, soft_cap, corr, sum);
    wg_wait<0>();  // O and P(t-1) are free again
    reg_fence(st.o);
#pragma unroll
    for (int i = 0; i < 2; ++i) st.l[i] = st.l[i] * corr[i] + sum[i];
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        st.o[n8 * 4 + i * 2] *= corr[i];
        st.o[n8 * 4 + i * 2 + 1] *= corr[i];
      }
    split_p<BN>(s, ph, pl);
  }
  reg_fence(st.o);
  wg_fence();
  start_pv<D, BN>(st, ph, pl, v_s + ((n_tiles - 1) % 3) * kTile);
  wg_commit();
  wg_wait<0>();
  reg_fence(st.o);
}

}  // namespace tile90
