// The paged MLA latent-attention kernel body shared by
// paged_attention_multi_mla.cu (latent pages in bf16, the compute dtype)
// and paged_attention_multi_mla_quant.cu (int8 latent pages with
// per-position f32 scales): each of those sources states the TPU kernel it
// replaces and instantiates this template for its page type behind its own
// __global__ kernel and C entries. It runs on Hopper's tensor cores
// (sm_90a) on the primitives of attention_tile_sm90.cuh.
//
// Function (the absorbed form of Multi-head Latent Attention): query row
// (b, j, h) holds q_lat (R, the query folded through w_uk) and q_rope (DR,
// the decoupled rope query), both f32. The pages its page_table row (B, N)
// names hold, per position, the normed latent c (R) and the shared rotated
// rope key kr (DR); pages are HEADLESS: every head of every query reads the
// same rows. score = scale * (q_lat . c + q_rope . kr); lengths (B,)
// counts valid tokens INCLUDING the K new ones, query j sits at position
// lengths - K + j and sees positions <= that (causal inside the block); the
// output is the softmax-weighted latent sum_p p * c (R, f32), which the
// caller up-projects through w_uv. Table entries at or after
// ceil(lengths / T) are never read, nor columns past the table's width, so
// the sink page never is.
//
// Design: a block owns 64 query rows of one sequence, query-major (row =
// j * Hq + h, as _paged_multi_mla_q stacks them: at Hq = 32 two query
// positions x 32 heads), and every row reads the same staged keys, so the
// latent tile is the shared B operand of wgmma for all heads. Tiles of 32
// keys [c | kr] (576 bf16 columns, gathered page by page by 16-byte
// cp.async into the swizzled layout) are walked with an online softmax:
//   S = q [c | kr]^T   wgmma m64n32k16, q from shared memory (K-major);
//   O += P c           wgmma m64n256k16, P from registers, c read MN-major
//                      from the same staged bytes.
// One warpgroup cannot hold a 64 x 512 f32 accumulator (256 registers a
// thread), so two warpgroups split R into halves of 256: each computes its
// half of q_lat . c^T and half of the rope term (32 of the 64 rope columns),
// the two partial S meet in shared memory and each adds the other's (f32
// addition commutes, so both hold the same S bit for bit), both run the
// same online softmax, and each runs P c for its half of O.
//
// Every f32 operand enters the tensor cores as bf16 hi + lo (products of
// bf16 values are exact in f32): q = q_lat * scale (the reference scales q
// in f32) as two shared-memory tiles, the rope query as two register
// fragment sets, P as split_p's two fragment sets. q in bf16 alone would
// move every score by ~2^-9 relative, outside the 1.3-ulp tolerance of the
// card check; the pages are bf16 (or int8) and exact as they are.
// Shared memory (of the 232,448 bytes a block may take): q hi + lo for 64
// rows x 512 columns, 131,072 B (q_rope in registers: that saves 16 KB);
// bf16 pages: two key stages of 36,864 B (the tile t + 1 lands while t
// computes); the two partial-S slots, 16,384 B; 222,208 B in all. int8
// pages: the int8 values are staged raw by cp.async (two stages of 18,688
// B with their scales) and widened to bf16 integers (exact) into one key
// stage, 222,976 B in all. The scores of an int8 tile are S_c * c_scale +
// S_r * kr_scale per key, the scales applied after the products; P is
// multiplied by c_scale before P c, so the output differs from the
// reference's (int8 * scale) . c by f32 rounding only, and the int8 arena
// keeps its bytes.
//
// Decode (few row tiles) splits each sequence's pages into contiguous
// ranges planned from shapes alone (the wrapper's _mla_split_plan): each
// split writes its rows' unnormalised f32 accumulator, max and sum to
// scratch, and mla_merge_kernel combines them. Row tiles run longest causal
// band first.

#pragma once

#include <type_traits>

#include "attention_tile_sm90.cuh"

namespace mla {

using bf16 = __nv_bfloat16;
using tile90::kWarpgroup;

constexpr int kR = 512, kDR = 64;    // latent, rope widths of every MLA config
constexpr int kW = kR + kDR;         // columns of a key row [c | kr]
constexpr int kRows = 64;            // query rows a block owns
constexpr int kBN = 32;              // keys a tile
constexpr int kThreads = 2 * kWarpgroup;
constexpr uint32_t kQTile = kRows * kR * 2;        // q hi (or lo), bf16
constexpr uint32_t kKTile = kBN * kW * 2;          // a bf16 key tile
constexpr uint32_t kSlot = kRows * kBN * 4;        // a warpgroup's partial S
constexpr uint32_t kRaw = kBN * kW + 2 * kBN * 4;  // an int8 tile + scales

template <bool kQuant>
constexpr size_t smem_bytes() {
  return 1024 + 2 * size_t(kQTile) +
         (kQuant ? kKTile + 2 * kRaw + 2 * kBN * 4 : 2 * kKTile) + 2 * kSlot;
}

struct Params {
  int n_q, hq, page_tokens, table_width;
  float scale;
  int n_splits, pages_per_split;
};

// f32 pair -> its bf16 hi and lo words
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = tile90::bf16x2_bits(h);
  lo = tile90::bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// bytes k and k + 1 of w (int8) as a bf16 pair, exact
__device__ __forceinline__ uint32_t i8_bf16(uint32_t w, int k) {
  return tile90::bf16x2_bits(__floats2bfloat162_rn(
      float(static_cast<int8_t>(w >> (8 * k))),
      float(static_cast<int8_t>(w >> (8 * k + 8)))));
}

template <typename KV>
__device__ __forceinline__ void attend(
    const float* __restrict__ q_lat, const float* __restrict__ q_rope,
    const KV* __restrict__ c_pages, const KV* __restrict__ kr_pages,
    const float* __restrict__ c_scale, const float* __restrict__ kr_scale,
    const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ lengths, float* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ part_ml, const Params& p,
    unsigned char* smem) {
  using namespace tile90;
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  const uint32_t raw_addr = smem_addr(smem);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* gsm = smem + (base - raw_addr);  // the same, generic
  const uint32_t qh_s = base, ql_s = base + kQTile;
  const uint32_t key_s = base + 2 * kQTile;       // bf16 stage(s)
  const uint32_t raw_s = key_s + kKTile;          // int8: raw stages
  const uint32_t slot_s = key_s + (kQuant ? kKTile + 2 * kRaw : 2 * kKTile);
  const uint32_t scl_s = slot_s + 2 * kSlot;      // int8: the tile's scales
  float* slot = reinterpret_cast<float*>(gsm + (slot_s - base));
  const float* scl = reinterpret_cast<const float*>(gsm + (scl_s - base));

  const int n_rows = p.n_q * p.hq;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest first
  const int split = blockIdx.y, b = blockIdx.z;
  const int T = p.page_tokens;
  const int len = lengths[b];
  const int first_q = len - p.n_q;  // position of query 0
  const int wg = threadIdx.x / kWarpgroup;
  const int tw = threadIdx.x % kWarpgroup;
  const int t4 = tw % 4;
  int row[2], hi[2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = row0 + (tw / 32) * 16 + (tw % 32) / 4 + 8 * i;
    hi[i] = row[i] < n_rows ? first_q + row[i] / p.hq : -1;
  }

  // pages this block reads: up to the page of its newest query, never at or
  // past ceil(len / T) nor past the table's width (positions beyond its
  // columns are absent, as in the reference); then this split's range
  const int newest = first_q + (min(row0 + kRows, n_rows) - 1) / p.hq;
  const int live = (len + T - 1) / T;
  const int page_end =
      newest < 0 ? 0 : min(min(live, newest / T + 1), p.table_width);
  const int sp0 = split * p.pages_per_split;
  const int sp1 = min(page_end, sp0 + p.pages_per_split);
  const int key_begin = sp0 * T;
  const int key_end = min(sp1 * T, newest + 1);
  const int n_tiles =
      key_end > key_begin ? (key_end - key_begin + kBN - 1) / kBN : 0;
  // the zero-filled keys past the split's end are not the rows' to see
#pragma unroll
  for (int i = 0; i < 2; ++i) hi[i] = min(hi[i], key_end - 1);

  const int32_t* table = page_table + size_t(b) * p.table_width;
  auto page_row = [&](int pos) -> long long {
    return (long long)table[pos / T] * T + pos % T;
  };
  // the bf16 tile of keys key0 .. key0 + 31 into dst (zeros past key_end)
  auto load_bf16 = [&](uint32_t dst, int key0) {
#pragma unroll 3
    for (int idx = threadIdx.x; idx < kBN * (kW / 8); idx += kThreads) {
      const int r = idx / (kW / 8), ch = idx % (kW / 8);
      const bool ok = key0 + r < key_end;
      const long long pr = ok ? page_row(key0 + r) : 0;
      const KV* src = ch < kR / 8 ? c_pages + pr * kR + ch * 8
                                  : kr_pages + pr * kDR + (ch - kR / 8) * 8;
      cp16(dst + swz(kBN, r, ch), src, ok);
    }
  };
  // the raw int8 tile and its scales: c rows (512 B), kr rows (64 B), then
  // the c and kr scales of the 32 keys
  auto load_int8 = [&](uint32_t dst, int key0) {
    for (int idx = threadIdx.x; idx < kBN * (kW / 16); idx += kThreads) {
      const int r = idx / (kW / 16), ch = idx % (kW / 16);
      const bool ok = key0 + r < key_end;
      const long long pr = ok ? page_row(key0 + r) : 0;
      if (ch < kR / 16)
        cp16(dst + r * kR + ch * 16, c_pages + pr * kR + ch * 16, ok);
      else
        cp16(dst + kBN * kR + r * kDR + (ch - kR / 16) * 16,
             kr_pages + pr * kDR + (ch - kR / 16) * 16, ok);
    }
    if (threadIdx.x < 2 * kBN) {
      const int which = threadIdx.x / kBN, r = threadIdx.x % kBN;
      const bool ok = key0 + r < key_end;
      const long long pr = ok ? page_row(key0 + r) : 0;
      cp4(dst + kBN * kW + threadIdx.x * 4,
          (which ? kr_scale : c_scale) + pr, ok);
    }
  };
  // int8 raw stage -> the bf16 key stage (integers, exact) and the scales
  auto widen = [&](uint32_t src) {
    const unsigned char* rs = gsm + (src - base);
    for (int idx = threadIdx.x; idx < kBN * (kW / 16); idx += kThreads) {
      const int r = idx / (kW / 16), ch = idx % (kW / 16);
      const uint4 v = *reinterpret_cast<const uint4*>(
          rs + (ch < kR / 16 ? r * kR + ch * 16
                             : kBN * kR + r * kDR + (ch - kR / 16) * 16));
      const int oc = 2 * ch;  // bf16 chunks 2 ch, 2 ch + 1 of the row
      *reinterpret_cast<uint4*>(gsm + (key_s - base) + swz(kBN, r, oc)) =
          make_uint4(i8_bf16(v.x, 0), i8_bf16(v.x, 2), i8_bf16(v.y, 0),
                     i8_bf16(v.y, 2));
      *reinterpret_cast<uint4*>(gsm + (key_s - base) + swz(kBN, r, oc + 1)) =
          make_uint4(i8_bf16(v.z, 0), i8_bf16(v.z, 2), i8_bf16(v.w, 0),
                     i8_bf16(v.w, 2));
    }
    if (threadIdx.x < 2 * kBN)
      reinterpret_cast<float*>(gsm + (scl_s - base))[threadIdx.x] =
          reinterpret_cast<const float*>(rs + kBN * kW)[threadIdx.x];
  };

  float o[kR / 4];                      // this warpgroup's m64n256 O
#pragma unroll
  for (int i = 0; i < kR / 4; ++i) o[i] = 0.f;
  uint32_t qrh[2][4], qrl[2][4];        // its 32 rope columns, hi and lo
  if (n_tiles > 0) {
    if constexpr (kQuant) {
      load_int8(raw_s, key_begin);
      cp_commit();
      if (n_tiles > 1) load_int8(raw_s + kRaw, key_begin + kBN);
      cp_commit();
    } else {
      load_bf16(key_s, key_begin);
      cp_commit();
    }
    // q_lat * scale as bf16 hi and lo tiles (zero rows past the last)
    for (int idx = threadIdx.x; idx < kRows * (kR / 8); idx += kThreads) {
      const int r = idx / (kR / 8), ch = idx % (kR / 8);
      uint4 vh = make_uint4(0, 0, 0, 0), vl = vh;
      if (row0 + r < n_rows) {
        const float4* src = reinterpret_cast<const float4*>(
            q_lat + (size_t(b) * n_rows + row0 + r) * kR + ch * 8);
        const float4 a = __ldg(src), c = __ldg(src + 1);
        const float s = p.scale;
        split2(a.x * s, a.y * s, vh.x, vl.x);
        split2(a.z * s, a.w * s, vh.y, vl.y);
        split2(c.x * s, c.y * s, vh.z, vl.z);
        split2(c.z * s, c.w * s, vh.w, vl.w);
      }
      *reinterpret_cast<uint4*>(gsm + swz(kRows, r, ch)) = vh;
      *reinterpret_cast<uint4*>(gsm + kQTile + swz(kRows, r, ch)) = vl;
    }
    // the rope fragments: k16 slice kk of columns 32 wg + 16 kk
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float2 v = make_float2(0.f, 0.f);
          if (row[i] < n_rows)
            v = __ldg(reinterpret_cast<const float2*>(
                q_rope + (size_t(b) * n_rows + row[i]) * kDR + 32 * wg +
                16 * kk + 8 * half + 2 * t4));
          split2(v.x * p.scale, v.y * p.scale, qrh[kk][half * 2 + i],
                 qrl[kk][half * 2 + i]);
        }
  }

  float s[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
  [[maybe_unused]] float sr[kBN / 2];  // int8: the rope part of S
  uint32_t ph[kBN / 16][4], pl[kBN / 16][4];
  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = key_begin + t * kBN;
    uint32_t kt = key_s;  // this tile's bf16 keys
    if constexpr (kQuant) {
      cp_wait<1>();     // tile t's raw copies (t + 1's may be in flight)
      __syncthreads();  // every thread's; both warpgroups past tile t - 1
      widen(raw_s + (t & 1) * kRaw);
      fence_async_smem();  // the key tile (and q) visible to wgmma
      __syncthreads();     // ... for every thread; raw stage t & 1 free
      if (t + 2 < n_tiles) load_int8(raw_s + (t & 1) * kRaw, key0 + 2 * kBN);
      cp_commit();
    } else {
      cp_wait_all();       // tile t's copies landed
      fence_async_smem();  // ... and are visible to wgmma (q too)
      __syncthreads();     // every thread's; both warpgroups past t - 1
      if (t + 1 < n_tiles)
        load_bf16(key_s + ((t + 1) & 1) * kKTile, key0 + kBN);
      cp_commit();
      kt = key_s + (t & 1) * kKTile;
    }

    // this warpgroup's part of S: q hi and lo against its 256 latent
    // columns, and the rope query against its 32 rope columns
    reg_fence(s);
    if constexpr (kQuant) reg_fence(sr);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kR / 2 / 16; ++kk) {
      const uint32_t cb = 4 * wg + kk / 4, k32 = (kk % 4) * 32;
      const uint64_t bd = desc(kt + cb * kBN * 128 + k32, 16, 1024);
      MmaSS<kBN>::run(s, desc(qh_s + cb * kRows * 128 + k32, 16, 1024), bd,
                      kk > 0);
      MmaSS<kBN>::run(s, desc(ql_s + cb * kRows * 128 + k32, 16, 1024), bd,
                      1);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t bd =
          desc(kt + (kR / 64) * kBN * 128 + (2 * wg + kk) * 32, 16, 1024);
      if constexpr (kQuant) {
        MmaRS<kBN, 0>::run(sr, qrh[kk], bd, kk > 0);
        MmaRS<kBN, 0>::run(sr, qrl[kk], bd, 1);
      } else {
        MmaRS<kBN, 0>::run(s, qrh[kk], bd, 1);
        MmaRS<kBN, 0>::run(s, qrl[kk], bd, 1);
      }
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    if constexpr (kQuant) {
      reg_fence(sr);
#pragma unroll
      for (int n8 = 0; n8 < kBN / 8; ++n8)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n8 * 8 + 2 * t4 + j;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = n8 * 4 + i * 2 + j;
            s[e] = s[e] * scl[col] + sr[e] * scl[kBN + col];
          }
        }
    }
    // the two halves' S: each adds the other's (the same sum in both)
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e)
      slot[(wg * (kBN / 2) + e) * kWarpgroup + tw] = s[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e)
      s[e] += slot[((1 - wg) * (kBN / 2) + e) * kWarpgroup + tw];

    // online softmax in log2 units; a key past a row's position is -inf
    float mx[2] = {m[0], m[1]}, corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n8 = 0; n8 < kBN / 8; ++n8)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = n8 * 4 + i * 2 + j;
          const float x = key0 + n8 * 8 + 2 * t4 + j <= hi[i]
                              ? s[e] * kLog2e
                              : kMinusInf;
          s[e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      corr[i] = exp2_ftz(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n8 = 0; n8 < kBN / 8; ++n8)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = n8 * 4 + i * 2 + j;
          const float pr = exp2_ftz(s[e] - m[i]);
          sum[i] += pr;
          // int8: p * c_scale meets the integer latents in P c
          s[e] = kQuant ? pr * scl[n8 * 8 + 2 * t4 + j] : pr;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
    reg_fence(o);
#pragma unroll
    for (int n8 = 0; n8 < kR / 2 / 8; ++n8)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[n8 * 4 + i * 2] *= corr[i];
        o[n8 * 4 + i * 2 + 1] *= corr[i];
      }
    split_p<kBN>(s, ph, pl);
    wg_fence();
    start_rs<kR / 2, kBN>(o, ph, pl, kt + 4 * wg * kBN * 128);
    wg_commit();
    wg_wait<0>();
    reg_fence(o);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    if (row[i] >= n_rows) continue;
    if (p.n_splits == 1) {
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
      float* dst = out + (size_t(b) * n_rows + row[i]) * kR + 256 * wg;
#pragma unroll
      for (int n8 = 0; n8 < kR / 2 / 8; ++n8)
        *reinterpret_cast<float2*>(dst + n8 * 8 + 2 * t4) = make_float2(
            o[n8 * 4 + i * 2] * inv, o[n8 * 4 + i * 2 + 1] * inv);
    } else {
      // scratch (B, splits, K * Hq, .): a split that saw no key of this row
      // writes only its sum 0, which the merge skips
      const size_t prow =
          (size_t(b) * p.n_splits + split) * n_rows + row[i];
      if (lsum > 0.f) {
        float* dst = part_o + prow * kR + 256 * wg;
#pragma unroll
        for (int n8 = 0; n8 < kR / 2 / 8; ++n8)
          *reinterpret_cast<float2*>(dst + n8 * 8 + 2 * t4) =
              make_float2(o[n8 * 4 + i * 2], o[n8 * 4 + i * 2 + 1]);
      }
      if (wg == 0 && t4 == 0)
        *reinterpret_cast<float2*>(part_ml + prow * 2) =
            make_float2(m[i], lsum);
    }
  }
}

// One warp per output row (b, j, head): the splits that saw a key,
// weighted by exp2(max_s - max), divided by the weighted sum.
__global__ void __launch_bounds__(128)
mla_merge_kernel(const float* __restrict__ part_o,
                 const float* __restrict__ part_ml, float* __restrict__ out,
                 int rows, int rows_per_seq, int n_splits) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int b = row / rows_per_seq;
  const size_t first =
      size_t(b) * n_splits * rows_per_seq + row % rows_per_seq;
  float mx = tile90::kNegInf;
  for (int s = 0; s < n_splits; ++s) {
    const float2 ml = *reinterpret_cast<const float2*>(
        part_ml + (first + size_t(s) * rows_per_seq) * 2);
    if (ml.y > 0.f) mx = fmaxf(mx, ml.x);
  }
  float4 acc[kR / 128] = {};
  float l = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const size_t prow = first + size_t(s) * rows_per_seq;
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + prow * 2);
    if (!(ml.y > 0.f)) continue;
    const float w = exp2f(ml.x - mx);
    l += w * ml.y;
#pragma unroll
    for (int e = 0; e < kR / 128; ++e) {
      const float4 v = reinterpret_cast<const float4*>(
          part_o + prow * kR + 128 * e)[lane];
      acc[e].x += w * v.x;
      acc[e].y += w * v.y;
      acc[e].z += w * v.z;
      acc[e].w += w * v.w;
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < kR / 128; ++e)
    reinterpret_cast<float4*>(out + size_t(row) * kR + 128 * e)[lane] =
        make_float4(acc[e].x * inv, acc[e].y * inv, acc[e].z * inv,
                    acc[e].w * inv);
}

// Whether the kernel takes these shapes (the Python wrappers check first).
inline bool shapes_ok(int latent, int rope, int page_tokens) {
  return latent == kR && rope == kDR && page_tokens > 0 &&
         page_tokens % 8 == 0;
}

// One launch of kernel (a __global__ wrapper of attend) and, when the pages
// are split, the merge.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int batch, const Params& p,
           float* out, const float* part_o, const float* part_ml,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rows = p.n_q * p.hq;
  const dim3 grid((n_rows + kRows - 1) / kRows, p.n_splits, batch);
  kernel<<<grid, kThreads, smem, stream>>>(args..., p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return static_cast<int>(err);
  const int rows = batch * n_rows;
  mla_merge_kernel<<<(rows + 3) / 4, 128, 0, stream>>>(
      part_o, part_ml, out, rows, n_rows, p.n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mla
