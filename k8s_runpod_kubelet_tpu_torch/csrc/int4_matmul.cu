// Matmul against int4-packed weights for Hopper (sm_90a): bf16 activations
// in and out, f32 math.
//
// Replaces: k8s_runpod_kubelet_tpu/ops/int4_matmul.py:_kernel (launched by
// _matmul_2d). Same function:
//   y[r, o] = sum_g scale[g, o] * sum_i (h[r, 2i] * (lo - 8)
//                                        + h[r, 2i + 1] * (hi - 8))
//   over group g's packed rows i, where q4 (in/2, out) uint8 holds
//   in-element 2i in the low nibble (lo) and 2i + 1 in the high (hi), and
//   scale (g, 1, out) f32 has one group per in/g contraction elements. Each
//   group's partial sum is formed in f32 and then scaled, as the TPU kernel
//   does; the output is cast to bf16 once.
//
// What bounds it on an H100: bytes at decode, where a few rows meet the
// whole packed weight (8 rows of 4096 -> 14336: 29.4 MB of q4 and 1.8 MB of
// scales, a 9.3 us bound); operations at prefill (1024 rows: 120 GFLOP,
// 0.12 ms at the bf16 tensor peak). This first version runs the products
// on the CUDA cores in f32, 16 FMAs per weight byte at 8 rows, which at
// decode is close to the byte bound in instructions and at prefill is one
// to two orders of magnitude behind a tensor-core GEMM.
//
// Design: the TPU kernel walks the groups as a sequential grid axis and
// carries the sum in VMEM. Here one block owns a tile of rows x output
// columns and walks its groups in a loop; each thread keeps 8 rows x 4
// columns of f32 partials and sums in registers. Per chunk of 32 packed
// rows the threads first issue their 32 four-byte weight loads (coalesced
// along out), then stage the rows' h slice in shared memory as f32, then
// unpack each byte's two nibbles (an OR into a float's mantissa and one
// subtract, exact) and run the FMAs; unpacked weights are reused across the
// thread's 8 rows. Decode has few rows and, at out = 1024, few column
// tiles: the launch then splits the groups over more blocks, each writing
// f32 partial sums that a second small kernel adds and casts. Tensor-core
// tiles (mma.sync / wgmma on the unpacked bf16 nibbles) and cp.async or TMA
// staging are left to later work; this version is the simple, exact one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 8;   // rows a thread owns
constexpr int kTN = 4;   // output columns a thread owns (one 4-byte load)
constexpr int kKC = 32;  // packed rows (64 in-elements) a chunk stages

// nibble (w >> shift) & 0xF minus 8, exactly: the float 2^23 + n minus
// 2^23 + 8
__device__ __forceinline__ float nibble(uint32_t w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFu) | 0x4B000000u) - 8388616.f;
}

template <int RT, int CT>
__global__ void __launch_bounds__(RT * CT)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ h,
                   const uint8_t* __restrict__ q4,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ y,
                   float* __restrict__ partial, int rows, int kin, int out,
                   int groups, int splits) {
  constexpr int BM = RT * kTM;
  constexpr int BN = CT * kTN;
  constexpr int NT = RT * CT;
  __shared__ __align__(16) float hs[BM][2 * kKC];

  const int tid = threadIdx.x;
  const int ct = tid % CT;
  const int rt = tid / CT;  // uniform across a warp: h reads broadcast
  const int col = blockIdx.x * BN + ct * kTN;
  const int row0 = blockIdx.z * BM;
  const int half = kin / 2 / groups;  // packed rows a group holds
  const int g_per = (groups + splits - 1) / splits;
  const int g_begin = blockIdx.y * g_per;
  const int g_end = min(groups, g_begin + g_per);
  const bool col_ok = col < out;  // out % 4 == 0: all four columns or none

  float acc[kTM][kTN];
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[r][c] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
    float part[kTM][kTN];
#pragma unroll
    for (int r = 0; r < kTM; ++r)
#pragma unroll
      for (int c = 0; c < kTN; ++c) part[r][c] = 0.f;
    for (int j0 = 0; j0 < half; j0 += kKC) {
      const int kc = min(kKC, half - j0);
      const size_t prow = size_t(g) * half + j0;  // first packed row
      uint32_t wv[kKC];
#pragma unroll
      for (int jj = 0; jj < kKC; ++jj) {
        wv[jj] = 0u;  // rows past the group: h is staged 0 there
        if (col_ok && jj < kc)
          wv[jj] = __ldg(reinterpret_cast<const unsigned int*>(
              q4 + (prow + jj) * out + col));
      }
      __syncthreads();  // every thread is done with the previous chunk
      for (int idx = tid; idx < BM * 2 * kKC; idx += NT) {
        const int r = idx / (2 * kKC);
        const int e = idx % (2 * kKC);
        float v = 0.f;
        if (row0 + r < rows && e < 2 * kc)
          v = __bfloat162float(h[size_t(row0 + r) * kin + 2 * prow + e]);
        hs[r][e] = v;
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < kKC; ++jj) {
        float lo[kTN], hi[kTN];
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          lo[c] = nibble(wv[jj], 8 * c);
          hi[c] = nibble(wv[jj], 8 * c + 4);
        }
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
          const float2 hv =
              *reinterpret_cast<const float2*>(&hs[rt * kTM + r][2 * jj]);
#pragma unroll
          for (int c = 0; c < kTN; ++c)
            part[r][c] = fmaf(hv.y, hi[c], fmaf(hv.x, lo[c], part[r][c]));
        }
      }
    }
    if (col_ok) {
      const float4 s =
          *reinterpret_cast<const float4*>(scale + size_t(g) * out + col);
      const float sc[kTN] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int r = 0; r < kTM; ++r)
#pragma unroll
        for (int c = 0; c < kTN; ++c)
          acc[r][c] = fmaf(part[r][c], sc[c], acc[r][c]);
    }
  }

  if (!col_ok) return;
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const int row = row0 + rt * kTM + r;
    if (row >= rows) break;
    if (splits > 1) {
      *reinterpret_cast<float4*>(
          partial + (size_t(blockIdx.y) * rows + row) * out + col) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
      __nv_bfloat162* o2 =
          reinterpret_cast<__nv_bfloat162*>(y + size_t(row) * out + col);
      o2[0] = __floats2bfloat162_rn(acc[r][0], acc[r][1]);
      o2[1] = __floats2bfloat162_rn(acc[r][2], acc[r][3]);
    }
  }
}

// y = bf16(sum over splits of the f32 partials), elementwise
__global__ void int4_matmul_reduce_kernel(const float* __restrict__ partial,
                                          __nv_bfloat16* __restrict__ y,
                                          int splits, size_t n) {
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += size_t(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[size_t(k) * n + i];
    y[i] = __float2bfloat16_rn(s);
  }
}

template <int RT, int CT>
int launch(const void* h, const void* q4, const void* scale, void* y,
           void* partial, int rows, int kin, int out, int groups, int splits,
           cudaStream_t stream) {
  constexpr int BM = RT * kTM;
  constexpr int BN = CT * kTN;
  const dim3 grid((out + BN - 1) / BN, splits, (rows + BM - 1) / BM);
  int4_matmul_kernel<RT, CT><<<grid, RT * CT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const uint8_t*>(q4),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(partial), rows, kin, out, groups, splits);
  return static_cast<int>(cudaGetLastError());
}

// blocks a launch aims for before it splits the groups over more blocks:
// twice the H100's 132 SMs
constexpr int kTargetBlocks = 2 * 132;

}  // namespace

// How many slices the groups are split into: enough blocks to cover the
// card's SMs twice when few rows and few output tiles leave it underfilled
// (decode at out = 1024), never a slice with no group. The tile choice
// (8 x 256 for rows <= 16, else 64 x 128) is int4_matmul_bf16's. The
// wrapper sizes the f32 scratch from this, and the entry splits by it.
extern "C" int int4_matmul_splits(int rows, int out, int groups) {
  const int bm = rows <= 16 ? 1 * kTM : 8 * kTM;
  const int bn = rows <= 16 ? 64 * kTN : 32 * kTN;
  const int blocks = ((rows + bm - 1) / bm) * ((out + bn - 1) / bn);
  int splits = (kTargetBlocks + blocks - 1) / blocks;
  splits = splits < groups ? splits : groups;
  splits = splits > 1 ? splits : 1;
  const int per = (groups + splits - 1) / splits;  // groups a slice walks
  return (groups + per - 1) / per;
}

// C entry point bound by ops/int4_matmul.py through ctypes. h (rows, kin)
// bf16, q4 (kin/2, out) uint8, scale (groups, 1, out) f32, y (rows, out)
// bf16; when int4_matmul_splits(rows, out, groups) is above 1, partial is
// an f32 (splits, rows, out) scratch the caller allocated. Returns 0 or a
// cudaError_t code; cudaErrorInvalidValue for shapes the kernel does not
// take (the Python wrapper rejects those before calling).
extern "C" int int4_matmul_bf16(const void* h, const void* q4,
                                const void* scale, void* y, void* partial,
                                int rows, int kin, int out, int groups,
                                void* stream) {
  if (rows == 0 || out == 0) return 0;
  if (kin <= 0 || kin % 2 || groups <= 0 || (kin / 2) % groups || out % kTN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = int4_matmul_splits(rows, out, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code = rows <= 16
                 ? launch<1, 64>(h, q4, scale, y, partial, rows, kin, out,
                                 groups, splits, s)
                 : launch<8, 32>(h, q4, scale, y, partial, rows, kin, out,
                                 groups, splits, s);
  if (code != 0 || splits == 1) return code;
  const size_t n = size_t(rows) * out;
  const int blocks = static_cast<int>(
      n / 256 + 1 < 4096 ? n / 256 + 1 : 4096);
  int4_matmul_reduce_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(y),
      splits, n);
  return static_cast<int>(cudaGetLastError());
}
