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
//            window keeps q - k < window as well. Query row i sits at
//            position q_offset + i, key j at j (q_offset >= 0): ring
//            attention's step t runs a q chunk against the K/V chunk
//            t * s_local positions behind it (ring_attention.py:_ring_flash
//            calls the TPU kernels so; its mask is _causal_mask).
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
// blocks in no order, so that axis becomes a loop inside the block. All
// three run on the tensor cores through the tile primitives of
// attention_tile_sm90.cuh: wgmma with hand-built descriptors over
// 128-byte-swizzled shared tiles, cp.async double buffering, f32
// accumulators in registers. Every product of two bf16 operands is exact in
// f32; every product with an f32 operand (P, dS) takes it as bf16 hi + lo
// register fragments (split_p), two wgmmas into one f32 accumulator.
//   - forward: the tile body's attend (online softmax on the accumulator
//     fragments, P V split). One block per (b, q head, 128 query rows: two
//     warpgroups sharing each staged K/V tile); the block walks only the k
//     tiles of its causal (and window) band, the longest bands first.
//   - dQ: one block per (b, q head, 128 query rows, two warpgroups). Q, dO,
//     lse and delta are staged once; the block walks the K/V tiles of its
//     band (BN keys), the longest bands of the whole grid first. Per tile:
//     S = Q K^T and dP = dO V^T (both operands K-major), P = exp2(S scale
//     log2 e - lse log2 e) with masked entries exactly 0, dS = P (dP -
//     delta), dQ += dS K with K read MN-major from the same swizzled bytes
//     (the forward's read of V). Step t starts S(t) and dP(t) with dQ +=
//     dS(t-1) K(t-1), and computes dS(t) while that product runs: three K
//     stages, two V stages.
//   - dK/dV: one block per (b, kv head, 64 key rows, one warpgroup; two
//     blocks an SM, so one block's elementwise work runs under the other's
//     products). K and V are staged once; the block walks the group's q
//     heads x the q tiles (BN rows) that can see its keys, so the GQA sum
//     stays in registers and no atomics are needed. The transposed forms
//     keep every f32 operand a register A fragment: S^T = K Q^T and dP^T =
//     V dO^T (shared x shared), dV += P^T dO and dK += dS^T Q with dO and Q
//     read MN-major. At D = 256 the two 64 x 256 f32 accumulators would
//     take 256 registers a thread, at D = 192 192 of them beside the S^T
//     and dP^T fragments: the block runs two passes over its band instead,
//     dV (S^T only) then dK, in one accumulator. There each q tile's product
//     lands in a zeroed partial that the CUDA cores add to the band's sum,
//     and dS enters the dK product as three bf16 terms: summed straight in
//     the wgmma accumulator over a band's hundreds of tiles, with dS in two
//     terms, dK lost its low bits toward a soft cap (FLASH_DKV_STRAIGHT,
//     below).
// BN is 64, or 32 at D = 256, whose m64n256 accumulator takes 128 registers
// a thread. At D = 192 (MLA's direct form: q = [q_nope 128, q_rope 64], k =
// [k_nope, kr], v zero-padded to 192, one kv head a q head) the forward
// keeps BN 64 (96 + 32 + 32 registers of fragments, as D = 256's 128 + 16 +
// 16) and the backward takes BN 32: dQ's fragments then stay at D = 256's
// count, and the two-pass dK/dV block's shared memory (K, V, two 32-row
// stages of Q and dO) at 97.5 KB, two blocks an SM. Every product whose N
// is the head dimension runs as one m64n192k16 wgmma over three swizzle
// atoms (tile90::MmaRS<192>).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF

struct Problem {
  int hq, hkv, sq, sk;
  float scale, soft_cap;             // soft_cap <= 0: none
  int causal, window;                // window <= 0: none (needs causal)
  int q_offset;                      // position of query row 0 (>= 0)
};

// the keys query row r sees: lo <= key <= hi (hi < lo: none); rows at or
// past sq see none. The band moves with q_offset; the row guard does not.
__device__ __forceinline__ void band(const Problem& p, int r, int* lo,
                                     int* hi) {
  const int pos = p.q_offset + r;
  *lo = p.causal && p.window > 0 ? pos - p.window + 1 : 0;
  *hi = r >= p.sq ? -1 : p.causal ? min(pos, p.sk - 1) : p.sk - 1;
}

// the k tiles [begin, end) a q tile [q0, q0 + bm) can see (begin <= end)
__device__ __forceinline__ void k_range(const Problem& p, int q0, int bm,
                                        int bn, int* begin, int* end) {
  const int n_k = (p.sk + bn - 1) / bn;
  *begin = 0;
  *end = n_k;
  if (!p.causal) return;
  const int pos_last = p.q_offset + min(q0 + bm, p.sq) - 1;
  *end = min(n_k, pos_last / bn + 1);
  if (p.window > 0) {
    const int k_first = p.q_offset + q0 - p.window + 1;
    if (k_first > 0) *begin = min(k_first / bn, *end);
  }
}

// the q tiles [begin, end) that can see a k tile [k0, k0 + bn)
// (begin <= end)
__device__ __forceinline__ void q_range(const Problem& p, int k0, int bn,
                                        int bm, int* begin, int* end) {
  const int n_q = (p.sq + bm - 1) / bm;
  *begin = 0;
  *end = n_q;
  if (!p.causal) return;
  // the first row whose position reaches k0
  *begin = min(n_q, max(k0 - p.q_offset, 0) / bm);
  if (p.window > 0) {
    // the last row whose position is within the window of the tile's last key
    const int r_last = min(k0 + bn, p.sk) - 1 + p.window - 1 - p.q_offset;
    *end = r_last < 0 ? 0 : min(n_q, r_last / bm + 1);
    *end = max(*end, *begin);
  }
}

// FLASH_DKV_STRAIGHT=1 builds the two-pass dK/dV block (D >= 192) as it
// was before the dK repair: each q tile's dK product summed straight in the
// wgmma accumulator, dS in two bf16 terms. That lost the low bits where
// dK's partial sums reach ~40 and the result is near 0 (74 of 16.8 M dK
// elements over the per-element check at Gemma 2's global head with q x 8;
// PERF.md section 6 keeps the candidates read by
// workloads/flash_large_logits.py). It is the card test's control; the
// default build sums each product apart and feeds dS as three terms.
#ifndef FLASH_DKV_STRAIGHT
#define FLASH_DKV_STRAIGHT 0
#endif

// dS's fragments: split_p's hi and lo, and with TERMS 3 the rest below
// them in rest (left untouched otherwise)
template <int BN, int TERMS>
__device__ __forceinline__ void split_ds(const float (&x)[BN / 2],
                                         uint32_t (&h)[BN / 16][4],
                                         uint32_t (&l)[BN / 16][4],
                                         uint32_t (&rest)[BN / 16][4]) {
  using namespace tile90;
  if constexpr (TERMS == 3) {
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float x0 = x[n8 * 4 + i * 2], x1 = x[n8 * 4 + i * 2 + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        const float r0 = x0 - hf.x, r1 = x1 - hf.y;
        const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
        const float2 mf = __bfloat1622float2(mid);
        const int a = n8 / 2, c = (n8 % 2) * 2 + i;
        h[a][c] = bf16x2_bits(hi);
        l[a][c] = bf16x2_bits(mid);
        rest[a][c] = bf16x2_bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
      }
  } else {
    split_p<BN>(x, h, l);
  }
}

// acc += dS B: start_rs over hi and lo, then with TERMS 3 the rest's
// wgmmas; started and not waited for
template <int N, int BN, int TERMS>
__device__ __forceinline__ void start_ds(float (&acc)[N / 2],
                                         const uint32_t (&h)[BN / 16][4],
                                         const uint32_t (&l)[BN / 16][4],
                                         const uint32_t (&rest)[BN / 16][4],
                                         uint32_t b_s) {
  using namespace tile90;
  start_rs<N, BN>(acc, h, l, b_s);
  if constexpr (TERMS == 3) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      MmaRS<N>::run(acc, rest[kk], desc(b_s + kk * 16 * 128, BN * 128, 1024));
  }
}

// acc += A B over one staged tile, waited for: A dS's TERMS terms
// (start_ds) or, with TERMS 0, P's hi and lo (start_rs), straight into acc,
// or with kTileSum into a zeroed partial that the CUDA cores add to acc
// (the default two-pass dK/dV block)
template <int D, int BN, int TERMS, bool kTileSum>
__device__ __forceinline__ void add_product(float (&acc)[D / 2],
                                            const uint32_t (&h)[BN / 16][4],
                                            const uint32_t (&l)[BN / 16][4],
                                            const uint32_t (&rest)[BN / 16][4],
                                            uint32_t b_s) {
  using namespace tile90;
  const auto start = [&](float (&d)[D / 2]) {
    if constexpr (TERMS > 0)
      start_ds<D, BN, TERMS>(d, h, l, rest, b_s);
    else
      start_rs<D, BN>(d, h, l, b_s);
  };
  if constexpr (kTileSum) {
    float part[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) part[i] = 0.f;
    reg_fence(part);
    wg_fence();
    start(part);
    wg_commit();
    wg_wait<0>();
    reg_fence(part);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += part[i];
  } else {
    reg_fence(acc);
    wg_fence();
    start(acc);
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
  }
}

// the generic pointer of a shared-memory address inside the block's buffer
__device__ __forceinline__ float* smem_ptr(unsigned char* base,
                                           uint32_t addr) {
  return reinterpret_cast<float*>(base + (addr - tile90::smem_addr(base)));
}

// ---------------------------------------------------------------- forward --

// On the tensor cores (attention_tile_sm90.cuh): a block of WG warpgroups
// owns 64 WG query rows of one (b, q head) and walks the key tiles of its
// causal (and window) band, BN keys a tile (32 at D = 256, whose m64n256
// output fragment takes 128 registers a thread; 64 at D = 192, whose
// m64n192 fragment takes 96).
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
    band(p, wg_row0 + tile90::Rows<D>::row(i), &st.lo[i], &st.hi[i]);
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

// --------------------------------------------------------------- backward --

// The backward's tiles: a warpgroup owns 64 rows (query rows in dQ, key rows
// in dK/dV); the streamed tile (keys in dQ, queries in dK/dV) has BN rows,
// 32 at D = 192 and 256 (the file's header).
template <int D>
struct BwdPick {
  static constexpr int BN = D >= 192 ? 32 : 64;
  static constexpr int DQ_WG = 2;    // dQ: two warpgroups share a K/V tile
  static constexpr int DKV_WG = 1;   // dK/dV: one warpgroup, two blocks an SM
};

// One thread's accumulator pair (i, j) of 8-column block n8: element index.
__device__ __forceinline__ int frag(int n8, int i, int j) {
  return n8 * 4 + i * 2 + j;
}

// This thread's two rows of a warpgroup's 64, row0 + row(i), written to the
// (n_rows, D) bf16 slab at base from the f32 accumulator fragment times
// mul; rows at or past n_rows are skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, const float (&acc)[D / 2],
                                           int row0, int n_rows, float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + tile90::Rows<D>::row(i);
    if (r >= n_rows) continue;
    bf16* row = base + static_cast<size_t>(r) * D;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      *reinterpret_cast<__nv_bfloat162*>(row + tile90::Rows<D>::col(n8, 0)) =
          __floats2bfloat162_rn(acc[frag(n8, i, 0)] * mul,
                                acc[frag(n8, i, 1)] * mul);
  }
}

// dQ: a block of WG warpgroups owns BM = 64 WG query rows of one (b, q
// head). Blocks are numbered (row tile, (b, head)) with the row tile
// slowest and the longest causal bands first over the whole grid.
template <int D, int BN, int WG>
__global__ void __launch_bounds__(WG * tile90::kWarpgroup, 1)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ d_o,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                Problem p) {
  using namespace tile90;
  constexpr int BM = kRows * WG, THREADS = kWarpgroup * WG;
  constexpr uint32_t kTile = BN * D * 2;  // bytes of one K or V tile
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const int n_qt = (p.sq + BM - 1) / BM;
  const int pairs = gridDim.x / n_qt;
  const int pair = blockIdx.x % pairs;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / pairs) * BM;
  const int b = pair / p.hq, h = pair % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const size_t qh = size_t(b) * p.hq + h, kh = size_t(b) * p.hkv + hk;
  const int sq = p.sq, sk = p.sk;

  // this thread's two rows: the keys each sees (lo <= key <= hi, hi < 0:
  // none), lse in log2 units and delta
  const int wg_row0 = q0 + (threadIdx.x / kWarpgroup) * kRows;
  int lo[2], hi[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = wg_row0 + Rows<D>::row(i);
    band(p, qp, &lo[i], &hi[i]);
    lse2[i] = qp < sq ? lse[qh * sq + qp] * kLog2e : 0.f;
    dlt[i] = qp < sq ? delta[qh * sq + qp] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  int kt0, kt1;
  k_range(p, q0, BM, BN, &kt0, &kt1);
  const int key_begin = kt0 * BN, n_tiles = kt1 - kt0;
  if (n_tiles > 0) {
    const uint32_t q_s = (smem_addr(smem_tc) + 1023u) & ~1023u;
    const uint32_t do_s = q_s + BM * D * 2;
    const uint32_t k_s = do_s + BM * D * 2;  // K stages t % 3
    const uint32_t v_s = k_s + 3 * kTile;    // V stages t % 2
    const auto q_src = [=](int r) -> long long {
      return q0 + r < sq ? static_cast<long long>(q0 + r) * D : -1;
    };
    load_rows<BM, D, THREADS>(q_s, q + qh * sq * D, q_src);
    load_rows<BM, D, THREADS>(do_s, d_o + qh * sq * D, q_src);
    const bf16* kb = k + kh * sk * D;
    const bf16* vb = v + kh * sk * D;
    const auto tile_src = [=](int key0) {
      return [=](int r) -> long long {
        return key0 + r < sk ? static_cast<long long>(key0 + r) * D : -1;
      };
    };
    load_kv<BN, D, THREADS>(k_s, v_s, kb, vb, tile_src(key_begin));
    cp_commit();

    const bool capped = p.soft_cap > 0.f;
    const float mul = capped ? p.scale / p.soft_cap : p.scale * kLog2e;
    const float post = p.soft_cap * kLog2e;
    const uint32_t wg_off = (threadIdx.x / kWarpgroup) * kRows * 128;
    float s[BN / 2], dp[BN / 2];
    uint32_t dh[BN / 16][4], dl[BN / 16][4];
    for (int t = 0; t < n_tiles; ++t) {
      cp_wait_all();       // tile t landed
      fence_async_smem();  // ... and is visible to wgmma
      __syncthreads();     // every warpgroup is past step t - 1
      if (t + 1 < n_tiles)
        load_kv<BN, D, THREADS>(k_s + ((t + 1) % 3) * kTile,
                                v_s + ((t + 1) & 1) * kTile, kb, vb,
                                tile_src(key_begin + (t + 1) * BN));
      cp_commit();

#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
      reg_fence(s);
      reg_fence(dp);
      reg_fence(acc);
      wg_fence();
      start_scores<D, BN>(s, q_s + wg_off, BM, k_s + (t % 3) * kTile);
      start_scores<D, BN>(dp, do_s + wg_off, BM, v_s + (t & 1) * kTile);
      wg_commit();
      if (t > 0) {
        start_rs<D, BN>(acc, dh, dl, k_s + ((t - 1) % 3) * kTile);
        wg_commit();
        wg_wait<1>();  // S and dP; dQ += dS(t-1) K(t-1) may still run
      } else {
        wg_wait<0>();
      }
      reg_fence(s);
      reg_fence(dp);

      // dS = P (dP - delta) [* (1 - tanh^2)] in place of dP
      const int key0 = key_begin + t * BN;
      const bool whole = key0 >= lo[0] && key0 >= lo[1] &&
                         key0 + BN - 1 <= hi[0] && key0 + BN - 1 <= hi[1];
#pragma unroll
      for (int n8 = 0; n8 < BN / 8; ++n8)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = frag(n8, i, j);
            float x = s[e] * mul, th = 0.f;
            if (capped) {
              th = tanhf(x);
              x = post * th;
            }
            float pr = exp2_ftz(x - lse2[i]);
            if (!whole) {
              const int key = key0 + Rows<D>::col(n8, j);
              if (key < lo[i] || key > hi[i]) pr = 0.f;
            }
            float ds = pr * (dp[e] - dlt[i]);
            if (capped) ds *= 1.f - th * th;
            dp[e] = ds;
          }
      wg_wait<0>();  // the fragments of dS(t-1) are free again
      reg_fence(acc);
      split_p<BN>(dp, dh, dl);
    }
    reg_fence(acc);
    wg_fence();
    start_rs<D, BN>(acc, dh, dl, k_s + ((n_tiles - 1) % 3) * kTile);
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
  }
  store_rows<D>(dq + qh * sq * D, acc, wg_row0, sq, p.scale);
}

// One pass of a dK/dV block over the q tiles of its band: kDV accumulates
// dV += P^T dO into dv, kDK dK += dS^T Q into dk (both in one pass, or one
// each in two passes sharing an accumulator). The stream stages, two of
// each: Q tiles, dO tiles (BN x D), then lse and delta (BN f32 each).
template <int D, int BN, int WG, bool kDV, bool kDK>
__device__ __forceinline__ void dkv_pass(
    float (&dv)[D / 2], float (&dk)[D / 2], unsigned char* smem,
    uint32_t k_wg, uint32_t v_wg, uint32_t stream_s, const Problem& p,
    const bf16* q, const bf16* d_o, const float* lse, const float* delta,
    size_t qh0, int kp0, int qt0, int nq, int n_tiles) {
  using namespace tile90;
  constexpr int BMK = kRows * WG, THREADS = kWarpgroup * WG;
  constexpr uint32_t kTile = BN * D * 2;
  const uint32_t qs = stream_s, dos = stream_s + 2 * kTile;
  const uint32_t ls = stream_s + 4 * kTile;  // stage: lse[BN], delta[BN]
  const int sq = p.sq, sk = p.sk;
  const auto load = [&](int t) {
    const int st = t & 1;
    const size_t qh = qh0 + t / nq;
    const int q0 = (qt0 + t % nq) * BN;
    load_kv<BN, D, THREADS>(
        qs + st * kTile, dos + st * kTile, q + qh * sq * D,
        d_o + qh * sq * D, [=](int r) -> long long {
          return q0 + r < sq ? static_cast<long long>(q0 + r) * D : -1;
        });
    for (int r = threadIdx.x; r < 2 * BN; r += THREADS) {
      const int row = q0 + r % BN;
      const float* src = (r < BN ? lse : delta) + qh * sq + (row < sq ? row : 0);
      cp4(ls + (st * 2 * BN + r) * 4, src, row < sq);
    }
  };
  load(0);
  cp_commit();

  const bool capped = p.soft_cap > 0.f;
  const float mul = capped ? p.scale / p.soft_cap : p.scale * kLog2e;
  const float post = p.soft_cap * kLog2e;
  int kp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kp[i] = kp0 + Rows<D>::row(i);
  float s[BN / 2], dp[BN / 2];
  uint32_t fh[BN / 16][4], fl[BN / 16][4];  // P^T, then dS^T, hi and lo
  uint32_t fr[BN / 16][4];  // dS^T's third term
  // the two-pass block (one accumulator) has the registers for a partial
  // and a third term
  constexpr bool kTileSum = !FLASH_DKV_STRAIGHT && D >= 192;
  constexpr int kTerms = kTileSum ? 3 : 2;
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait_all();
    fence_async_smem();
    __syncthreads();  // tile t landed; every thread is past step t - 1
    if (t + 1 < n_tiles) load(t + 1);
    cp_commit();
    const int st = t & 1;
    const int q0 = (qt0 + t % nq) * BN;
    const int pos0 = p.q_offset + q0;  // the tile's first query position

#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
    reg_fence(s);
    reg_fence(dp);
    wg_fence();
    start_scores<D, BN>(s, k_wg, BMK, qs + st * kTile);
    if constexpr (kDK) start_scores<D, BN>(dp, v_wg, BMK, dos + st * kTile);
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // P^T in place of S^T, dS^T in place of dP^T; rows are this thread's
    // keys, columns the tile's queries
    const float* lse_c = smem_ptr(smem, ls + st * 2 * BN * 4);
    const float* del_c = lse_c + BN;
    const bool whole =
        q0 + BN - 1 < sq && kp[1] < sk &&
        (!p.causal || (kp[1] <= pos0 &&
                       (p.window <= 0 || pos0 + BN - 1 - kp[0] < p.window)));
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = Rows<D>::col(n8, j), qp = q0 + c, pos = pos0 + c;
        const float l2 = lse_c[c] * kLog2e;
        const float dc = del_c[c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = frag(n8, i, j);
          float x = s[e] * mul, th = 0.f;
          if (capped) {
            th = tanhf(x);
            x = post * th;
          }
          float pr = exp2_ftz(x - l2);
          if (!whole) {
            const bool seen =
                qp < sq && kp[i] < sk &&
                (!p.causal || (kp[i] <= pos &&
                               (p.window <= 0 || pos - kp[i] < p.window)));
            if (!seen) pr = 0.f;
          }
          s[e] = pr;
          if constexpr (kDK) {
            float ds = pr * (dp[e] - dc);
            if (capped) ds *= 1.f - th * th;
            dp[e] = ds;
          }
        }
      }
    // one pair of fragment registers, P^T's then dS^T's: the dV product
    // completes before dS^T is split (two fragment pairs beside both
    // accumulators would pass the 255 registers a thread has at D = 128)
    if constexpr (kDV) {
      split_p<BN>(s, fh, fl);
      add_product<D, BN, 0, kTileSum>(dv, fh, fl, fr, dos + st * kTile);
    }
    if constexpr (kDK) {
      split_ds<BN, kTerms>(dp, fh, fl, fr);
      add_product<D, BN, kTerms, kTileSum>(dk, fh, fl, fr, qs + st * kTile);
    }
  }
}

// dK/dV: a block of WG warpgroups owns BMK = 64 WG key rows of one (b, kv
// head). Blocks are numbered (key tile, (b, kv head)) with the key tile
// slowest: under a causal mask the first key tiles see the most queries.
// Two blocks share an SM, except at D = 256, whose tiles take 130 KB of
// shared memory (97.5 KB at D = 192). At D = 192 and 256 the block runs two
// passes over its band, dV then dK, in one accumulator.
template <int D, int BN, int WG>
__global__ void __launch_bounds__(WG * tile90::kWarpgroup, D == 256 ? 1 : 2)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ d_o,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, Problem p) {
  using namespace tile90;
  constexpr int BMK = kRows * WG, THREADS = kWarpgroup * WG;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const int n_kt = (p.sk + BMK - 1) / BMK;
  const int pairs = gridDim.x / n_kt;
  const int pair = blockIdx.x % pairs;
  const int k0 = static_cast<int>(blockIdx.x) / pairs * BMK;
  const int b = pair / p.hkv, hk = pair % p.hkv;
  const int group = p.hq / p.hkv;
  const size_t kh = size_t(b) * p.hkv + hk;
  const size_t qh0 = size_t(b) * p.hq + size_t(hk) * group;
  const int sk = p.sk;
  const int wg_row0 = k0 + (threadIdx.x / kWarpgroup) * kRows;

  int qt0, qt1;
  q_range(p, k0, BMK, BN, &qt0, &qt1);
  const int nq = max(qt1 - qt0, 0), n_tiles = group * nq;
  const uint32_t k_s = (smem_addr(smem_tc) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + BMK * D * 2;
  const uint32_t stream_s = v_s + BMK * D * 2;
  const uint32_t wg_off = (threadIdx.x / kWarpgroup) * kRows * 128;
  if (n_tiles > 0)
    load_kv<BMK, D, THREADS>(k_s, v_s, k + kh * sk * D, v + kh * sk * D,
                             [=](int r) -> long long {
                               return k0 + r < sk
                                          ? static_cast<long long>(k0 + r) * D
                                          : -1;
                             });
  bf16* dk_rows = dk + kh * sk * D;
  bf16* dv_rows = dv + kh * sk * D;
  if constexpr (D >= 192) {
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    if (n_tiles > 0)
      dkv_pass<D, BN, WG, true, false>(acc, acc, smem_tc, k_s + wg_off,
                                       v_s + wg_off, stream_s, p, q, d_o,
                                       lse, delta, qh0, wg_row0, qt0, nq,
                                       n_tiles);
    store_rows<D>(dv_rows, acc, wg_row0, sk, 1.f);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    if (n_tiles > 0) {
      __syncthreads();  // every thread is done with the first pass's stages
      dkv_pass<D, BN, WG, false, true>(acc, acc, smem_tc, k_s + wg_off,
                                       v_s + wg_off, stream_s, p, q, d_o,
                                       lse, delta, qh0, wg_row0, qt0, nq,
                                       n_tiles);
    }
    store_rows<D>(dk_rows, acc, wg_row0, sk, p.scale);
  } else {
    float acc_v[D / 2], acc_k[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_v[i] = acc_k[i] = 0.f;
    if (n_tiles > 0)
      dkv_pass<D, BN, WG, true, true>(acc_v, acc_k, smem_tc, k_s + wg_off,
                                      v_s + wg_off, stream_s, p, q, d_o,
                                      lse, delta, qh0, wg_row0, qt0, nq,
                                      n_tiles);
    store_rows<D>(dv_rows, acc_v, wg_row0, sk, 1.f);
    store_rows<D>(dk_rows, acc_k, wg_row0, sk, p.scale);
  }
}

// ------------------------------------------------------------- launchers --

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

// a one-dimensional grid of row tiles x pairs, or 0 past its limit
inline unsigned grid_1d(int rows, int tile, long long pairs) {
  const long long n = static_cast<long long>((rows + tile - 1) / tile) * pairs;
  return n > 0x7fffffffLL ? 0u : static_cast<unsigned>(n);
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* d_o,
       const void* lse, const void* delta, void* out, int batch,
       const Problem& p, cudaStream_t stream) {
  constexpr int BN = BwdPick<D>::BN, WG = BwdPick<D>::DQ_WG;
  constexpr int BM = tile90::kRows * WG;
  // Q and dO, three K and two V stages, 1 KB to align the base
  const size_t smem = 1024 + 2 * size_t(BM) * D * 2 + 5 * size_t(BN) * D * 2;
  auto kernel = flash_dq_kernel<D, BN, WG>;
  const unsigned grid = grid_1d(p.sq, BM, static_cast<long long>(p.hq) * batch);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, WG * tile90::kWarpgroup, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* d_o,
        const void* lse, const void* delta, void* dk, void* dv, int batch,
        const Problem& p, cudaStream_t stream) {
  constexpr int BN = BwdPick<D>::BN, WG = BwdPick<D>::DKV_WG;
  constexpr int BMK = tile90::kRows * WG;
  // K and V, two stages of Q, dO, lse and delta, 1 KB to align the base
  const size_t smem = 1024 + 2 * size_t(BMK) * D * 2 +
                      4 * size_t(BN) * D * 2 + 4 * size_t(BN) * 4;
  auto kernel = flash_dkv_kernel<D, BN, WG>;
  const unsigned grid =
      grid_1d(p.sk, BMK, static_cast<long long>(p.hkv) * batch);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<grid, WG * tile90::kWarpgroup, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), p);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int batch, int hq, int hkv, int sq, int sk, int causal,
           int window, int q_offset) {
  return batch > 0 && hkv > 0 && hq % hkv == 0 && sq > 0 && sk > 0 &&
         (window <= 0 || causal) && q_offset >= 0;
}

Problem problem(int hq, int hkv, int sq, int sk, float scale, float soft_cap,
                int causal, int window, int q_offset) {
  Problem p;
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.sk = sk;
  p.scale = scale;
  p.soft_cap = soft_cap;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  return p;
}

}  // namespace

// C entry points bound by ops/attention.py through ctypes. Each returns 0 or
// a cudaError_t code; cudaErrorInvalidValue for shapes the kernels do not
// take (the Python wrappers reject those before calling). Layouts: q, o, dO,
// dq (B, Hq, Sq, D); k, v, dk, dv (B, Hkv, Sk, D); lse, delta (B, Hq, Sq)
// f32; all contiguous. q_offset: the position of query row 0 (>= 0).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int batch, int hq, int hkv,
                              int sq, int sk, int head_dim, float scale,
                              float soft_cap, int causal, int window,
                              int q_offset, void* stream) {
  if (!valid(batch, hq, hkv, sq, sk, causal, window, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p =
      problem(hq, hkv, sq, sk, scale, soft_cap, causal, window, q_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return fwd<64>(q, k, v, o, lse, batch, p, s);
    case 128: return fwd<128>(q, k, v, o, lse, batch, p, s);
    case 192: return fwd<192>(q, k, v, o, lse, batch, p, s);
    case 256: return fwd<256>(q, k, v, o, lse, batch, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v,
                             const void* d_o, const void* lse,
                             const void* delta, void* dq_out, int batch,
                             int hq, int hkv, int sq, int sk, int head_dim,
                             float scale, float soft_cap, int causal,
                             int window, int q_offset, void* stream) {
  if (!valid(batch, hq, hkv, sq, sk, causal, window, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p =
      problem(hq, hkv, sq, sk, scale, soft_cap, causal, window, q_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return dq<64>(q, k, v, d_o, lse, delta, dq_out, batch, p, s);
    case 128: return dq<128>(q, k, v, d_o, lse, delta, dq_out, batch, p, s);
    case 192: return dq<192>(q, k, v, d_o, lse, delta, dq_out, batch, p, s);
    case 256: return dq<256>(q, k, v, d_o, lse, delta, dq_out, batch, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v,
                              const void* d_o, const void* lse,
                              const void* delta, void* dk_out, void* dv_out,
                              int batch, int hq, int hkv, int sq, int sk,
                              int head_dim, float scale, float soft_cap,
                              int causal, int window, int q_offset,
                              void* stream) {
  if (!valid(batch, hq, hkv, sq, sk, causal, window, q_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p =
      problem(hq, hkv, sq, sk, scale, soft_cap, causal, window, q_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return dkv<64>(q, k, v, d_o, lse, delta, dk_out, dv_out, batch, p, s);
    case 128:
      return dkv<128>(q, k, v, d_o, lse, delta, dk_out, dv_out, batch, p, s);
    case 192:
      return dkv<192>(q, k, v, d_o, lse, delta, dk_out, dv_out, batch, p, s);
    case 256:
      return dkv<256>(q, k, v, d_o, lse, delta, dk_out, dv_out, batch, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
