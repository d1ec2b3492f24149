// Matmul against int4-packed weights for Hopper (sm_90a) on the tensor
// cores: bf16 activations in and out, f32 sums.
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
// 0.12 ms at the bf16 tensor peak).
//
// Design: the product runs transposed, y^T = W^T h^T, as wgmma m64nNRk16:
// the weights are the A operand (M = 64 output columns a warpgroup), taken
// from registers, and h is the B operand (N = NR rows, K-major: h's own
// row-major layout), read from shared memory. A nibble minus 8 is an integer
// in [-8, 7], exact in bf16, so every product of bf16 h and an unpacked
// weight is exact in f32; the weights are never rounded with their scale
// (folding the scale into bf16 weights costs ~2^-9 of every weight). The
// q4 bytes are read as the quantizer wrote them, with no repacked copy: an
// A fragment register holds the (k = 2i, 2i + 1) bf16 pair of one M row,
// which is exactly one byte's two nibbles, so each thread unpacks its bytes
// with integer ops (nibble | 0x4300 is bf16 128 + nibble, less 136 in one
// bf16x2 subtract). The M rows are mapped to output columns so that a
// thread's two rows (g and g + 8 of its warp) are adjacent columns: one
// 16-bit shared-memory read gives the two bytes of a packed row, and the
// accumulator's two rows are one bf16x2 (or float2) of the output.
//
// A block of two warpgroups owns 128 output columns and NR rows and walks
// its groups in steps of 128 in-elements (a group of 128, the quantizer's,
// is one step; a longer group takes several, a step past its end reads
// zeros). Per step, 16-byte cp.async copies bring the h tile (NR x 128
// bf16, the swizzled K-major layout of attention_tile_sm90.cuh) and the q4
// tile (64 packed rows x 128 bytes, rows padded to 144 bytes so the 16-bit
// reads meet no bank conflict) and the group's scales of the block's
// columns into a ring of STAGES stages; the step's
// eight wgmmas run into an f32 partial (the first overwrites it) while the
// threads unpack the next step's fragments; after a group's last step the
// group's two scales of each thread fold the partial into the running f32
// sum. Two regimes, chosen from the rows alone: prefill (NR = 128, four
// stages, one block an SM: two 64-register accumulators a thread) and
// decode (rows <= 16, NR = 16 with zero rows past the last, eight stages
// of 14 KB, two blocks an SM, so up to ~200 KB of weights are in flight on
// each SM). When the blocks of a launch cannot fill the card (decode, and
// prefill at out = 1024), the groups are split over more blocks, each
// writing f32 partial sums that a second small kernel adds and casts.

#include "attention_tile_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tile90::kWarpgroup;

constexpr int kWG = 2;                     // warpgroups a block
constexpr int kThreads = kWG * kWarpgroup;
constexpr int kBN = 64 * kWG;              // output columns a block owns
constexpr int kKC = 128;                   // in-elements a step stages
constexpr int kPR = kKC / 2;               // packed rows a step stages
constexpr int kQRow = kBN + 16;            // bytes of a staged q4 row
constexpr int kDecodeRows = 16;            // rows of the decode regime

// Bytes of one stage: the h tile, then the q4 tile (both multiples of 1 KB,
// so every stage's h tile keeps the swizzle's 1024-byte alignment).
template <int NR>
__host__ __device__ constexpr uint32_t h_bytes() { return NR * kKC * 2; }
template <int NR>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return h_bytes<NR>() + kPR * kQRow;
}
// then, after the ring, a ring of the steps' scale rows (kBN f32 each)
template <int NR, int STAGES>
constexpr size_t smem_bytes() {
  return 1024 + size_t(STAGES) * (stage_bytes<NR>() + kBN * 4);
}

// bf16 pair (nibble - 8) from a word holding a nibble in bits 0-3 and
// another in bits 16-19: | 0x4300 makes bf16 128 + nibble, exact, and the
// subtract of 136 is exact too.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t w) {
  const uint32_t v = w | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              __floats2bfloat162_rn(136.f, 136.f));
  return tile90::bf16x2_bits(r);
}

template <int NR, int STAGES>
__global__ void __launch_bounds__(kThreads, NR <= kDecodeRows ? 2 : 1)
int4_matmul_kernel(const bf16* __restrict__ h, const uint8_t* __restrict__ q4,
                   const float* __restrict__ scale, bf16* __restrict__ y,
                   float* __restrict__ partial, int rows, int kin, int out,
                   int groups, int splits) {
  using namespace tile90;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem + (base - raw);  // the same, generic
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  // this thread's output columns: M rows g8 and g8 + 8 of its warp
  const int cw = (tid / 32) * 16 + 2 * g8;     // within the block's kBN
  const int row0 = blockIdx.x * NR;
  const int col0 = blockIdx.z * kBN;
  const int col = col0 + cw;
  const int gs = kin / groups;                 // in-elements a group holds
  const int chunks = (gs + kKC - 1) / kKC;     // steps a group takes
  const int g_per = (groups + splits - 1) / splits;
  const int g_begin = blockIdx.y * g_per;
  const int n_steps =
      max(min(groups, g_begin + g_per) - g_begin, 0) * chunks;
  const uint32_t scales_s = base + STAGES * stage_bytes<NR>();

  // start the copies of step s into stage s % STAGES
  auto load = [&](int s) {
    const uint32_t st = base + (s % STAGES) * stage_bytes<NR>();
    const int k0 = (s % chunks) * kKC;         // in-element within the group
    const int kv = min(kKC, gs - k0);          // of the group, in this step
    const long long e0 = (long long)(g_begin + s / chunks) * gs + k0;
#pragma unroll
    for (int idx = tid; idx < NR * 16; idx += kThreads) {
      const int r = idx / 16, c = idx % 16;
      const bool ok = row0 + r < rows && c * 8 < kv;
      cp16(st + swz(NR, r, c),
           h + (ok ? (long long)(row0 + r) * kin + e0 + c * 8 : 0), ok);
    }
    const uint32_t qs = st + h_bytes<NR>();
#pragma unroll
    for (int idx = tid; idx < kPR * (kBN / 16); idx += kThreads) {
      const int i = idx / (kBN / 16), c = idx % (kBN / 16);
      const bool ok = 2 * i < kv && col0 + c * 16 < out;
      cp16(qs + i * kQRow + c * 16,
           q4 + (ok ? (e0 / 2 + i) * out + col0 + c * 16 : 0), ok);
    }
    if (tid < kBN / 4) {  // the group's scales of the block's columns
      const bool ok = col0 + tid * 4 < out;
      cp16(scales_s + (s % STAGES) * kBN * 4 + tid * 16,
           scale + (ok ? (size_t)(g_begin + s / chunks) * out + col0 +
                             tid * 4
                       : 0),
           ok);
    }
  };
  // the A fragments of step s: register (half * 2 + i) of k16 slice kk is
  // the pair (in-elements 16 kk + 8 half + 2 t4, + 1) of output column
  // cw + i, i.e. byte (packed row 8 kk + 4 half + t4, column cw + i)
  auto unpack = [&](int s, uint32_t(&a)[8][4]) {
    const unsigned char* q =
        gbase + (s % STAGES) * stage_bytes<NR>() + h_bytes<NR>() + cw;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t x = *reinterpret_cast<const uint16_t*>(
            q + (8 * kk + 4 * half + t4) * kQRow);
        const uint32_t lo = x & 0x0F0Fu, hi = (x >> 4) & 0x0F0Fu;
        a[kk][half * 2] = nibbles_bf16(__byte_perm(lo, hi, 0x7470));
        a[kk][half * 2 + 1] = nibbles_bf16(__byte_perm(lo, hi, 0x7571));
      }
  };

  float acc[NR / 2], part[NR / 2];
#pragma unroll
  for (int i = 0; i < NR / 2; ++i) acc[i] = part[i] = 0.f;
  uint32_t fa[8][4], fb[8][4];

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load(s);
    cp_commit();
  }
  cp_wait<STAGES - 2>();  // step 0's copies
  fence_async_smem();
  __syncthreads();
  if (n_steps > 0) unpack(0, fa);

  // step s: its eight products on fragments cur, the next step's
  // fragments unpacked into nxt meanwhile
  auto step = [&](int s, uint32_t(&cur)[8][4], uint32_t(&nxt)[8][4]) {
    const int c = s % chunks;
    const uint32_t hs = base + (s % STAGES) * stage_bytes<NR>();
    reg_fence(part);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      MmaRS<NR, 0>::run(part, cur[kk],
                        desc(hs + (kk / 4) * NR * 128 + (kk % 4) * 32, 16,
                             1024),
                        c > 0 || kk > 0);
    wg_commit();
    if (s + 1 < n_steps) {
      cp_wait<STAGES - 3>();  // step s + 1's copies
      fence_async_smem();
      __syncthreads();  // every thread's; every thread is past step s - 1
      if (s + STAGES - 1 < n_steps) load(s + STAGES - 1);  // stage of s - 1
      cp_commit();
      unpack(s + 1, nxt);
    }
    wg_wait<0>();
    reg_fence(part);
    if (c == chunks - 1) {
      const float2 sc = *reinterpret_cast<const float2*>(
          gbase + (scales_s - base) + (s % STAGES) * kBN * 4 + cw * 4);
#pragma unroll
      for (int n8 = 0; n8 < NR / 8; ++n8)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc[n8 * 4 + j] = fmaf(part[n8 * 4 + j], sc.x, acc[n8 * 4 + j]);
          acc[n8 * 4 + 2 + j] =
              fmaf(part[n8 * 4 + 2 + j], sc.y, acc[n8 * 4 + 2 + j]);
        }
    }
  };
  for (int s = 0; s < n_steps; s += 2) {
    step(s, fa, fb);
    if (s + 1 < n_steps) step(s + 1, fb, fa);
  }

  if (col >= out) return;
#pragma unroll
  for (int n8 = 0; n8 < NR / 8; ++n8)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row0 + n8 * 8 + 2 * t4 + j;
      if (r >= rows) continue;
      const float v0 = acc[n8 * 4 + j], v1 = acc[n8 * 4 + 2 + j];
      if (splits > 1)
        *reinterpret_cast<float2*>(
            partial + ((size_t)blockIdx.y * rows + r) * out + col) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r * out + col) =
            __floats2bfloat162_rn(v0, v1);
    }
}

// y = bf16(sum over splits of the f32 partials), four elements a thread
// (n % 4 == 0), eight splits' loads in flight
__global__ void int4_matmul_reduce_kernel(const float* __restrict__ partial,
                                          bf16* __restrict__ y, int splits,
                                          size_t n) {
  const float4* p4 = reinterpret_cast<const float4*>(partial);
  const size_t n4 = n / 4;
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += size_t(gridDim.x) * blockDim.x) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int k = 0; k < splits; ++k) {
      const float4 v = __ldg(p4 + size_t(k) * n4 + i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(y) + 2 * i;
    o[0] = __floats2bfloat162_rn(s.x, s.y);
    o[1] = __floats2bfloat162_rn(s.z, s.w);
  }
}

template <int NR, int STAGES>
int launch(const void* h, const void* q4, const void* scale, void* y,
           void* partial, int rows, int kin, int out, int groups, int splits,
           cudaStream_t stream) {
  auto kernel = int4_matmul_kernel<NR, STAGES>;
  constexpr size_t smem = smem_bytes<NR, STAGES>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // row tiles fastest: the blocks that share a column tile's weights run
  // together, so the weights come from device memory about once
  const dim3 grid((rows + NR - 1) / NR, splits, (out + kBN - 1) / kBN);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const uint8_t*>(q4),
      static_cast<const float*>(scale), static_cast<bf16*>(y),
      static_cast<float*>(partial), rows, kin, out, groups, splits);
  return static_cast<int>(cudaGetLastError());
}

// blocks the card holds at once (132 SMs): two an SM at decode, one at
// prefill; and the most splits of a tile (more blocks of one group each cost
// the reduce more than they save: at 8 x (4096 -> 1024), 32 splits read
// 0.0146-0.0153 ms on the H100, 8 splits 0.0134-0.0141)
constexpr int kDecodeBlocks = 2 * 132;
constexpr int kPrefillBlocks = 132;
constexpr int kMaxSplits = 8;

}  // namespace

// How many slices the groups are split into: as many as keep the blocks of
// a launch within one wave of the card's resident blocks when the tiles
// alone leave SMs idle (decode; prefill at out = 1024), at most kMaxSplits,
// never a slice with no group. The wrapper sizes the f32 scratch from this,
// and the entry splits by it.
extern "C" int int4_matmul_splits(int rows, int out, int groups) {
  const bool decode = rows <= kDecodeRows;
  const int nr = decode ? kDecodeRows : 128;
  const int blocks = ((rows + nr - 1) / nr) * ((out + kBN - 1) / kBN);
  int splits = (decode ? kDecodeBlocks : kPrefillBlocks) / blocks;
  splits = splits < kMaxSplits ? splits : kMaxSplits;
  splits = splits < groups ? splits : groups;
  splits = splits > 1 ? splits : 1;
  const int per = (groups + splits - 1) / splits;  // groups a slice walks
  return (groups + per - 1) / per;
}

// C entry point bound by ops/int4_matmul.py through ctypes. h (rows, kin)
// bf16, q4 (kin/2, out) uint8, scale (groups, 1, out) f32, y (rows, out)
// bf16, each 16-byte aligned; when int4_matmul_splits(rows, out, groups)
// is above 1, partial is an f32 (splits, rows, out) scratch the caller
// allocated. Returns 0 or a cudaError_t code; cudaErrorInvalidValue for
// shapes the kernel does not take (a group that is not a multiple of 16
// in-elements, out not a multiple of 16; the Python wrapper rejects those
// before calling).
extern "C" int int4_matmul_bf16(const void* h, const void* q4,
                                const void* scale, void* y, void* partial,
                                int rows, int kin, int out, int groups,
                                void* stream) {
  if (rows == 0 || out == 0) return 0;
  if (kin <= 0 || groups <= 0 || kin % groups || (kin / groups) % 16 ||
      out % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = int4_matmul_splits(rows, out, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code =
      rows <= kDecodeRows
          ? launch<kDecodeRows, 8>(h, q4, scale, y, partial, rows, kin, out,
                                   groups, splits, s)
          : launch<128, 4>(h, q4, scale, y, partial, rows, kin, out, groups,
                           splits, s);
  if (code != 0 || splits == 1) return code;
  const size_t n = size_t(rows) * out;
  const int blocks = static_cast<int>(
      n / 1024 + 1 < 4096 ? n / 1024 + 1 : 4096);
  int4_matmul_reduce_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<bf16*>(y), splits, n);
  return static_cast<int>(cudaGetLastError());
}
