// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels; bf16 in
// and out, f32 math and f32 softmax statistics.
//
// Replaces: k8s_runpod_kubelet_tpu/ops/attention.py:_fwd_kernel (launched by
// _flash_fwd_pallas), :_dq_kernel and :_dkv_kernel (launched by
// _flash_bwd_pallas). Same functions:
//   forward  q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> o (B, Hq, Sq, D) and the
//            row log-sum-exp lse (B, Hq, Sq) f32. GQA group = Hq / Hkv. Scores
//            are (q * scale) . k; the optional soft cap (cap * tanh(s / cap))
//            applies before the mask; causal keeps k <= q, and the optional
//            window keeps q - k < window as well.
//   dQ       dq = scale * sum_k dS k, dS = P (dP - delta) [* (1 - tanh^2)],
//            P = exp(s - lse), dP = dO . v, delta = rowsum(dO o) (computed by
//            the caller in f32, as the JAX package does in XLA).
//   dK/dV    dv = sum P^T dO and dk = scale * sum dS^T q over every q head of
//            the GQA group, written once at Hkv in k's dtype.
// Differences from the TPU kernels, all on purpose: any Sq, Sk >= 1 (the
// ragged tail of a tile is masked here; the JAX wrapper sends shapes its
// blocks do not divide to XLA instead), and a row that sees no key at all
// (a window, or Sq > Sk) gives o = 0, lse = -1e30 and no gradient, because
// masked probabilities are zeroed explicitly rather than left to exp(-1e30).
//
// What bounds it on an H100: operations. At the training shape (B 8, Hq 32,
// S 2048, D 128, causal) the forward does 4*B*Hq*S^2*D/2 = 0.275 TFLOP over
// 0.34 GB of inputs and outputs, some 800 flops a byte; dQ and dK/dV 1.5x and
// 2x those flops.
//
// Design: the TPU kernels carry the online-softmax state, or the dQ/dK/dV
// sums, in VMEM across a sequential ("arbitrary") grid axis; Hopper runs
// blocks in no order, so that axis becomes a loop inside the block.
//   - forward: on the tensor cores, the tile body of attention_tile_sm90.cuh
//     (wgmma Q K^T, f32 online softmax on the accumulator fragments, P V as
//     two bf16 products of P's hi and lo halves, cp.async double-buffered
//     K/V tiles). One block per (b, q head, tile of 128 query rows: two
//     warpgroups sharing each staged K/V tile); the block walks only the k
//     tiles of its causal (and window) band, the longest bands first.
//   - dQ: one block per (b, q head, tile of BM query rows) over the same
//     band.
//   - dK/dV: one block per (b, kv head, tile of BN key rows); the block walks
//     the group's q heads x the q tiles that can see its keys, so the GQA sum
//     stays in registers and no atomics are needed (the same choice the TPU
//     kernel makes by gridding over kv heads).
// The dQ and dK/dV blocks stage their tiles in shared memory as f32 (rows
// padded to an odd stride, so column walks hit distinct banks). 256 threads
// form a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j of each tile: a register-tiled product on the CUDA cores in f32
// (67 TFLOP/s peak), which bounds those two kernels. D is a template
// parameter (64, 128, 256); D = 256 uses 32-row tiles there to stay inside
// shared memory and registers. Tensor-core tiles for the backward are left
// to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile_sm90.cuh"

namespace {

constexpr int kThreads = 256;        // a 16 x 16 thread grid
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF

struct Problem {
  int hq, hkv, sq, sk;
  float scale, soft_cap;             // soft_cap <= 0: none
  int causal, window;                // window <= 0: none (needs causal)
};

__device__ __forceinline__ bool keep(const Problem& p, int qp, int kp) {
  if (kp >= p.sk) return false;
  if (!p.causal) return true;
  return kp <= qp && (p.window <= 0 || qp - kp < p.window);
}

// rows [r0, r0 + R) of a (n_rows, D) bf16 slab into f32 shared memory with
// row stride LD, times mul; rows past n_rows read as zero
template <int R, int D, int LD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int r0, int n_rows, float mul) {
  constexpr int V = D / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < R * V; idx += kThreads) {
    const int r = idx / V;
    const int c = (idx % V) * 8;
    float* d = dst + r * LD + c;
    if (r0 + r < n_rows) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + size_t(r0 + r) * D + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        d[2 * i] = f.x * mul;
        d[2 * i + 1] = f.y * mul;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = 0.f;
    }
  }
}

// rows [r0, r0 + R) of a (n_rows,) f32 vector; past the end reads as zero
template <int R>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int n_rows) {
  for (int r = threadIdx.x; r < R; r += kThreads)
    dst[r] = r0 + r < n_rows ? src[r0 + r] : 0.f;
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d]
template <int RM, int CN, int D, int LD>
__device__ __forceinline__ void mm_abt(float (&acc)[RM][CN], const float* A,
                                       const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RM], b[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < CN; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k P[ty + 16 i][k] * B[k][tx + 16 j], k < K
template <int RM, int DC, int K, int LDP, int LDB>
__device__ __forceinline__ void mm_ab(float (&acc)[RM][DC], const float* P,
                                      const float* B, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RM], b[DC];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = P[(ty + 16 * i) * LDP + k];
#pragma unroll
    for (int j = 0; j < DC; ++j) b[j] = B[k * LDB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r P[r][ty + 16 i] * B[r][tx + 16 j], r < R
template <int RK, int DC, int R, int LDP, int LDB>
__device__ __forceinline__ void mm_atb(float (&acc)[RK][DC], const float* P,
                                       const float* B, int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    float a[RK], b[DC];
#pragma unroll
    for (int i = 0; i < RK; ++i) a[i] = P[r * LDP + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < DC; ++j) b[j] = B[r * LDB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// the k tiles [begin, end) a q tile [q0, q0 + bm) can see
__device__ __forceinline__ void k_range(const Problem& p, int q0, int bm,
                                        int bn, int* begin, int* end) {
  const int n_k = (p.sk + bn - 1) / bn;
  *begin = 0;
  *end = n_k;
  if (!p.causal) return;
  const int q_last = min(q0 + bm, p.sq) - 1;
  *end = min(n_k, q_last / bn + 1);
  if (p.window > 0) {
    const int k_first = q0 - p.window + 1;
    if (k_first > 0) *begin = k_first / bn;
  }
}

// the q tiles [begin, end) that can see a k tile [k0, k0 + bn)
__device__ __forceinline__ void q_range(const Problem& p, int k0, int bn,
                                        int bm, int* begin, int* end) {
  const int n_q = (p.sq + bm - 1) / bm;
  *begin = 0;
  *end = n_q;
  if (!p.causal) return;
  *begin = min(n_q, k0 / bm);
  if (p.window > 0) {
    const int q_last = min(k0 + bn, p.sk) - 1 + p.window - 1;
    *end = min(n_q, q_last / bm + 1);
  }
}

__device__ __forceinline__ float capped(const Problem& p, float s, float* th) {
  if (p.soft_cap > 0.f) {
    *th = tanhf(s / p.soft_cap);
    return *th * p.soft_cap;
  }
  *th = 0.f;
  return s;
}

template <int D, int RM, int CN>
struct Tiles {
  static constexpr int BM = 16 * RM;   // rows of a q tile
  static constexpr int BN = 16 * CN;   // rows of a k tile
  static constexpr int DC = D / 16;    // accumulator columns a thread owns
  static constexpr int LD = D + 1;     // padded row stride of D-wide tiles
  static constexpr int LS = BN + 1;    // padded row stride of score tiles
};

// ---------------------------------------------------------------- forward --

// On the tensor cores (attention_tile_sm90.cuh): a block of WG warpgroups
// owns 64 WG query rows of one (b, q head) and walks the key tiles of its
// causal (and window) band, BN keys a tile (32 at D = 256, whose m64n256
// output fragment takes 128 registers a thread).
template <int D>
struct FwdPick {
  static constexpr int BN = D == 256 ? 32 : 64;
  static constexpr int WG = 2;
};

template <int D, int BN, int WG>
__global__ void __launch_bounds__(WG * tile90::kWarpgroup, 1)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 Problem p) {
  constexpr int BM = tile90::kRows * WG;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest bands first
  const int hk = h / (p.hq / p.hkv);
  const size_t qh = size_t(b) * p.hq + h, kh = size_t(b) * p.hkv + hk;

  tile90::Rows<D> st;
  st.init();
  const int wg_row0 = q0 + (threadIdx.x / tile90::kWarpgroup) * tile90::kRows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = wg_row0 + tile90::Rows<D>::row(i);
    st.lo[i] = p.causal && p.window > 0 ? qp - p.window + 1 : 0;
    st.hi[i] = qp >= p.sq ? -1 : p.causal ? min(qp, p.sk - 1) : p.sk - 1;
  }
  int kt0, kt1;
  k_range(p, q0, BM, BN, &kt0, &kt1);
  const int sq = p.sq, sk = p.sk;
  tile90::attend<D, BN, WG>(
      st, smem_tc, q + qh * sq * D,
      [=](int r) -> long long {
        return q0 + r < sq ? static_cast<long long>(q0 + r) * D : -1;
      },
      k + kh * sk * D, v + kh * sk * D,
      [=](int key) -> long long {
        return key < sk ? static_cast<long long>(key) * D : -1;
      },
      kt0 * BN, kt1 - kt0, p.scale, p.soft_cap);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = wg_row0 + tile90::Rows<D>::row(i);
    const float l = tile90::quad_sum(st.l[i]);
    if (qp >= p.sq) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = o + (qh * p.sq + qp) * D;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      *reinterpret_cast<__nv_bfloat162*>(orow +
                                         tile90::Rows<D>::col(n8, 0)) =
          __floats2bfloat162_rn(st.o[n8 * 4 + i * 2] * inv,
                                st.o[n8 * 4 + i * 2 + 1] * inv);
    // natural-log lse from the log2-unit max; -1e30 for a row with no key
    if (threadIdx.x % 4 == 0)
      lse[qh * p.sq + qp] =
          l > 0.f ? st.m[i] * tile90::kLn2 + logf(l) : kNegInf;
  }
}

// --------------------------------------------------------------------- dQ --

template <int D, int RM, int CN>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ d_o,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, Problem p) {
  using T = Tiles<D, RM, CN>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                       // BM x LD, times scale
  float* do_s = q_s + T::BM * T::LD;       // BM x LD
  float* k_s = do_s + T::BM * T::LD;       // BN x LD
  float* v_s = k_s + T::BN * T::LD;        // BN x LD
  float* ds_s = v_s + T::BN * T::LD;       // BM x LS
  float* lse_s = ds_s + T::BM * T::LS;     // BM
  float* delta_s = lse_s + T::BM;          // BM

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * T::BM;
  const int hk = h / (p.hq / p.hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qh = size_t(b) * p.hq + h, kh = size_t(b) * p.hkv + hk;
  const __nv_bfloat16* k_slab = k + kh * p.sk * D;
  const __nv_bfloat16* v_slab = v + kh * p.sk * D;

  load_tile<T::BM, D, T::LD>(q_s, q + qh * p.sq * D, q0, p.sq, p.scale);
  load_tile<T::BM, D, T::LD>(do_s, d_o + qh * p.sq * D, q0, p.sq, 1.f);
  load_rows<T::BM>(lse_s, lse + qh * p.sq, q0, p.sq);
  load_rows<T::BM>(delta_s, delta + qh * p.sq, q0, p.sq);

  float acc[RM][T::DC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < T::DC; ++j) acc[i][j] = 0.f;

  int kt0, kt1;
  k_range(p, q0, T::BM, T::BN, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * T::BN;
    __syncthreads();
    load_tile<T::BN, D, T::LD>(k_s, k_slab, k0, p.sk, 1.f);
    load_tile<T::BN, D, T::LD>(v_s, v_slab, k0, p.sk, 1.f);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
    mm_abt<RM, CN, D, T::LD>(s, q_s, k_s, ty, tx);
    mm_abt<RM, CN, D, T::LD>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = ty + 16 * i;
      const float lv = lse_s[row], dl = delta_s[row];
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        float th;
        const float sc = capped(p, s[i][j], &th);
        const float pv =
            keep(p, q0 + row, k0 + tx + 16 * j) ? expf(sc - lv) : 0.f;
        float ds = pv * (dp[i][j] - dl);
        if (p.soft_cap > 0.f) ds *= 1.f - th * th;
        ds_s[row * T::LS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();  // dS complete
    mm_ab<RM, T::DC, T::BN, T::LS, T::LD>(acc, ds_s, k_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.sq) continue;
    __nv_bfloat16* row = dq + (qh * p.sq + r) * D;
#pragma unroll
    for (int j = 0; j < T::DC; ++j)
      row[tx + 16 * j] = __float2bfloat16(acc[i][j] * p.scale);
  }
}

// ------------------------------------------------------------------ dK/dV --

template <int D, int RM, int CN>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ d_o,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, Problem p) {
  using T = Tiles<D, RM, CN>;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                       // BN x LD
  float* v_s = k_s + T::BN * T::LD;        // BN x LD
  float* q_s = v_s + T::BN * T::LD;        // BM x LD, times scale
  float* do_s = q_s + T::BM * T::LD;       // BM x LD
  float* p_s = do_s + T::BM * T::LD;       // BM x LS
  float* ds_s = p_s + T::BM * T::LS;       // BM x LS
  float* lse_s = ds_s + T::BM * T::LS;     // BM
  float* delta_s = lse_s + T::BM;          // BM

  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * T::BN;
  const int group = p.hq / p.hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t kh = size_t(b) * p.hkv + hk;

  load_tile<T::BN, D, T::LD>(k_s, k + kh * p.sk * D, k0, p.sk, 1.f);
  load_tile<T::BN, D, T::LD>(v_s, v + kh * p.sk * D, k0, p.sk, 1.f);

  // this thread's rows of the key tile are ty + 16 i, i < CN
  float dk_acc[CN][T::DC], dv_acc[CN][T::DC];
#pragma unroll
  for (int i = 0; i < CN; ++i)
#pragma unroll
    for (int j = 0; j < T::DC; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  int qt0, qt1;
  q_range(p, k0, T::BN, T::BM, &qt0, &qt1);
  for (int g = 0; g < group; ++g) {
    const size_t qh = size_t(b) * p.hq + size_t(hk) * group + g;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * T::BM;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T::BM, D, T::LD>(q_s, q + qh * p.sq * D, q0, p.sq, p.scale);
      load_tile<T::BM, D, T::LD>(do_s, d_o + qh * p.sq * D, q0, p.sq, 1.f);
      load_rows<T::BM>(lse_s, lse + qh * p.sq, q0, p.sq);
      load_rows<T::BM>(delta_s, delta + qh * p.sq, q0, p.sq);
      __syncthreads();

      float s[RM][CN], dp[RM][CN];
      mm_abt<RM, CN, D, T::LD>(s, q_s, k_s, ty, tx);
      mm_abt<RM, CN, D, T::LD>(dp, do_s, v_s, ty, tx);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row = ty + 16 * i;
        const int qp = q0 + row;
        const float lv = lse_s[row], dl = delta_s[row];
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          float th;
          const float sc = capped(p, s[i][j], &th);
          // rows past Sq were loaded as zeros; keep() drops them too
          const bool kp = qp < p.sq && keep(p, qp, k0 + tx + 16 * j);
          const float pv = kp ? expf(sc - lv) : 0.f;
          float ds = pv * (dp[i][j] - dl);
          if (p.soft_cap > 0.f) ds *= 1.f - th * th;
          p_s[row * T::LS + tx + 16 * j] = pv;
          ds_s[row * T::LS + tx + 16 * j] = ds;
        }
      }
      __syncthreads();  // P and dS complete
      mm_atb<CN, T::DC, T::BM, T::LS, T::LD>(dv_acc, p_s, do_s, ty, tx);
      mm_atb<CN, T::DC, T::BM, T::LS, T::LD>(dk_acc, ds_s, q_s, ty, tx);
    }
  }

  // q_s held q * scale, so dk_acc is already scale * sum dS^T q
#pragma unroll
  for (int i = 0; i < CN; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= p.sk) continue;
    __nv_bfloat16* dk_row = dk + (kh * p.sk + r) * D;
    __nv_bfloat16* dv_row = dv + (kh * p.sk + r) * D;
#pragma unroll
    for (int j = 0; j < T::DC; ++j) {
      dk_row[tx + 16 * j] = __float2bfloat16(dk_acc[i][j]);
      dv_row[tx + 16 * j] = __float2bfloat16(dv_acc[i][j]);
    }
  }
}

// ------------------------------------------------------------- launchers --

// 64 x 64 tiles, except D = 256, whose f32 tiles and accumulators need
// 32 x 32 to fit shared memory and registers
template <int D>
struct Pick {
  static constexpr int RM = D == 256 ? 2 : 4;
  static constexpr int CN = D == 256 ? 2 : 4;
};

// every kernel here takes more than the default 48 KB of dynamic shared memory
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int batch, const Problem& p, cudaStream_t stream) {
  constexpr int BN = FwdPick<D>::BN, WG = FwdPick<D>::WG;
  constexpr int BM = tile90::kRows * WG;
  const size_t smem = tile90::smem_bytes<D, BN, WG>();
  auto kernel = flash_fwd_kernel<D, BN, WG>;
  const dim3 grid((p.sq + BM - 1) / BM, p.hq, batch);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, WG * tile90::kWarpgroup, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* d_o,
       const void* lse, const void* delta, void* out, int batch,
       const Problem& p, cudaStream_t stream) {
  constexpr int RM = Pick<D>::RM, CN = Pick<D>::CN;
  using T = Tiles<D, RM, CN>;
  const size_t smem = sizeof(float) * (2 * T::BM * T::LD + 2 * T::BN * T::LD +
                                       T::BM * T::LS + 2 * T::BM);
  auto kernel = flash_dq_kernel<D, RM, CN>;
  const dim3 grid((p.sq + T::BM - 1) / T::BM, p.hq, batch);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(d_o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* d_o,
        const void* lse, const void* delta, void* dk, void* dv, int batch,
        const Problem& p, cudaStream_t stream) {
  constexpr int RM = Pick<D>::RM, CN = Pick<D>::CN;
  using T = Tiles<D, RM, CN>;
  const size_t smem = sizeof(float) * (2 * T::BN * T::LD + 2 * T::BM * T::LD +
                                       2 * T::BM * T::LS + 2 * T::BM);
  auto kernel = flash_dkv_kernel<D, RM, CN>;
  const dim3 grid((p.sk + T::BN - 1) / T::BN, p.hkv, batch);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(d_o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), p);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int batch, int hq, int hkv, int sq, int sk, int causal,
           int window) {
  return batch > 0 && hkv > 0 && hq % hkv == 0 && sq > 0 && sk > 0 &&
         (window <= 0 || causal);
}

Problem problem(int hq, int hkv, int sq, int sk, float scale, float soft_cap,
                int causal, int window) {
  Problem p;
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.sk = sk;
  p.scale = scale;
  p.soft_cap = soft_cap;
  p.causal = causal;
  p.window = window;
  return p;
}

}  // namespace

// C entry points bound by ops/attention.py through ctypes. Each returns 0 or
// a cudaError_t code; cudaErrorInvalidValue for shapes the kernels do not
// take (the Python wrappers reject those before calling). Layouts: q, o, dO,
// dq (B, Hq, Sq, D); k, v, dk, dv (B, Hkv, Sk, D); lse, delta (B, Hq, Sq)
// f32; all contiguous.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int batch, int hq, int hkv,
                              int sq, int sk, int head_dim, float scale,
                              float soft_cap, int causal, int window,
                              void* stream) {
  if (!valid(batch, hq, hkv, sq, sk, causal, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p = problem(hq, hkv, sq, sk, scale, soft_cap, causal, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return fwd<64>(q, k, v, o, lse, batch, p, s);
    case 128: return fwd<128>(q, k, v, o, lse, batch, p, s);
    case 256: return fwd<256>(q, k, v, o, lse, batch, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v,
                             const void* d_o, const void* lse,
                             const void* delta, void* dq_out, int batch,
                             int hq, int hkv, int sq, int sk, int head_dim,
                             float scale, float soft_cap, int causal,
                             int window, void* stream) {
  if (!valid(batch, hq, hkv, sq, sk, causal, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p = problem(hq, hkv, sq, sk, scale, soft_cap, causal, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return dq<64>(q, k, v, d_o, lse, delta, dq_out, batch, p, s);
    case 128: return dq<128>(q, k, v, d_o, lse, delta, dq_out, batch, p, s);
    case 256: return dq<256>(q, k, v, d_o, lse, delta, dq_out, batch, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v,
                              const void* d_o, const void* lse,
                              const void* delta, void* dk_out, void* dv_out,
                              int batch, int hq, int hkv, int sq, int sk,
                              int head_dim, float scale, float soft_cap,
                              int causal, int window, void* stream) {
  if (!valid(batch, hq, hkv, sq, sk, causal, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p = problem(hq, hkv, sq, sk, scale, soft_cap, causal, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return dkv<64>(q, k, v, d_o, lse, delta, dk_out, dv_out, batch, p, s);
    case 128:
      return dkv<128>(q, k, v, d_o, lse, delta, dk_out, dv_out, batch, p, s);
    case 256:
      return dkv<256>(q, k, v, d_o, lse, delta, dk_out, dv_out, batch, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
