// The paged MLA latent-attention kernel body shared by
// paged_attention_multi_mla.cu (latent pages in bf16, the compute dtype)
// and paged_attention_multi_mla_quant.cu (int8 latent pages with
// per-position f32 scales): each of those sources states the TPU kernel it
// replaces and instantiates this template for its page type behind its own
// __global__ kernel and C entry.
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
// ceil(lengths / T) are never read, so the sink page never is.
//
// Design: the TPU kernels walk pages as a sequential grid axis with the
// online-softmax state in VMEM scratch. Here the page walk is a loop inside
// the block: one block per (sequence, tile of query rows), rows ordered
// query-major (row = j * Hq + h, as _paged_multi_mla_q stacks them), each
// of 4 warps owning RPW rows whose state (max, sum, R-wide f32 accumulator)
// stays in registers. Per page the block stages the page's c (T x R) and kr
// (T x DR) tiles ONCE in shared memory as f32, for all its rows: bf16 pages
// convert there, int8 pages dequantize there (int8 * the position's scale,
// the reference's order of operations), so the inner loops read f32 only.
// The page walk is software-pipelined: cp.async copies page p + 1's raw
// tiles (and int8 scales) into a second shared buffer while the warps
// compute on page p, so a block that owns few rows (decode) does not wait
// out a global-memory round trip per page.
// A lane holds the row elements k * 128 + 4 * lane + {0..3} (float4 chunks)
// of q_lat and the accumulator, and k * 64 + 2 * lane + {0, 1} of q_rope,
// so a warp's shared-memory reads of a staged row are contiguous and free
// of bank conflicts; a score is a lane partial dot plus a warp butterfly
// sum. The row tile is chosen per launch: few rows (decode) put one row on
// a warp, 4 rows a block, so a decode batch spreads over tens of blocks
// that each re-read their sequence's pages (from L2 after the first); many
// rows (prefill chunks, K * Hq = 32768 at a 1024-token chunk) put four on a
// warp so each staged element feeds 4 FMAs per shared-memory read.
// Split-KV, wgmma and TMA are left to later work; this is the simple, exact
// version.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mla {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// cp.async of 16 bytes from global to shared memory (sm_80+), its group
// commit, and the wait for every group this thread committed
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One 16-byte vector of a page row into f32 shared memory: 8 bf16 values
__device__ __forceinline__ void stage_vec(const __nv_bfloat16* src, float,
                                          float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  float4* out = reinterpret_cast<float4*>(dst);
  out[0] = make_float4(a.x, a.y, b.x, b.y);
  out[1] = make_float4(c.x, c.y, d.x, d.y);
}

// ... or 16 int8 values times their position's scale
__device__ __forceinline__ void stage_vec(const int8_t* src, float scale,
                                          float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const char4* c = reinterpret_cast<const char4*>(&v);
  float4* out = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[k] = make_float4(static_cast<float>(c[k].x) * scale,
                         static_cast<float>(c[k].y) * scale,
                         static_cast<float>(c[k].z) * scale,
                         static_cast<float>(c[k].w) * scale);
}

// Start the copy of n contiguous bytes (a multiple of 16) into shared memory.
__device__ __forceinline__ void prefetch(const void* src, void* dst, int n) {
  for (int i = threadIdx.x; i < n / 16; i += kThreads)
    cp_async16(static_cast<char*>(dst) + 16 * i,
               static_cast<const char*>(src) + 16 * i);
}

// Convert one raw section in shared memory (T rows of W elements) to f32,
// int8 rows times their position's scale.
template <typename KV, int W>
__device__ __forceinline__ void widen(const KV* raw, const float* scale,
                                     float* dst, int page_tokens) {
  constexpr int kVec = 16 / sizeof(KV);  // elements per 16-byte vector
  constexpr int kPerRow = W / kVec;
  for (int idx = threadIdx.x; idx < page_tokens * kPerRow; idx += kThreads) {
    float s = 1.f;
    if constexpr (std::is_same<KV, int8_t>::value) s = scale[idx / kPerRow];
    stage_vec(raw + idx * kVec, s, dst + idx * kVec);
  }
}

// Shared memory of one block: the page's c and kr tiles in f32, then the
// raw tiles of the page in flight (and, int8, its two scale rows).
inline size_t smem_bytes(int page_tokens, int latent, int rope,
                         size_t elem_bytes) {
  const size_t t = page_tokens;
  return t * (latent + rope) * (sizeof(float) + elem_bytes) +
         (elem_bytes == 1 ? 2 * t * sizeof(float) : 0);
}

template <typename KV, int R, int DR, int RPW>
__device__ __forceinline__ void attend(
    const float* __restrict__ q_lat, const float* __restrict__ q_rope,
    const KV* __restrict__ c_pages, const KV* __restrict__ kr_pages,
    const float* __restrict__ c_scale, const float* __restrict__ kr_scale,
    const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ lengths, float* __restrict__ out, int n_q,
    int hq, int page_tokens, int table_width, float scale, float* smem) {
  static_assert(R % 128 == 0 && DR % 64 == 0, "R % 128, DR % 64");
  constexpr int RC = R / 128;    // float4 chunks of a row per lane
  constexpr int DC = DR / 64;    // float2 chunks of the rope part per lane
  constexpr int G = RPW == 1 ? 8 : 4;  // positions per softmax update
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  float* c_s = smem;
  float* kr_s = c_s + page_tokens * R;
  KV* c_raw = reinterpret_cast<KV*>(kr_s + page_tokens * DR);
  KV* kr_raw = c_raw + page_tokens * R;
  float* cs_raw = reinterpret_cast<float*>(kr_raw + page_tokens * DR);
  float* krs_raw = cs_raw + page_tokens;

  const int b = blockIdx.y;
  const int n_rows = n_q * hq;
  const int tile = kWarps * RPW;
  const int row0 = blockIdx.x * tile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = lengths[b];

  float4 ql[RPW][RC];
  float2 qr[RPW][DC];
  float4 acc[RPW][RC];
  float m[RPW];
  float l[RPW];
  int qpos[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + warp * RPW + i;
    m[i] = kNegInf;
    l[i] = 0.f;
    // a row past the last sees nothing: its probabilities stay 0
    qpos[i] = r < n_rows ? len - n_q + r / hq : -1;
#pragma unroll
    for (int k = 0; k < RC; ++k) {
      acc[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);
      ql[i][k] = acc[i][k];
    }
#pragma unroll
    for (int k = 0; k < DC; ++k) qr[i][k] = make_float2(0.f, 0.f);
    if (r < n_rows) {
      // (B, K, Hq, .) rows: row r of sequence b is (b * n_q * hq + r)
      const size_t row = size_t(b) * n_rows + r;
#pragma unroll
      for (int k = 0; k < RC; ++k) {
        const float4 v = reinterpret_cast<const float4*>(
            q_lat + row * R + k * 128)[lane];
        ql[i][k] = make_float4(v.x * scale, v.y * scale, v.z * scale,
                               v.w * scale);
      }
#pragma unroll
      for (int k = 0; k < DC; ++k) {
        const float2 v = reinterpret_cast<const float2*>(
            q_rope + row * DR + k * 64)[lane];
        qr[i][k] = make_float2(v.x * scale, v.y * scale);
      }
    }
  }

  // pages this block reads: up to the page of its newest query, never at or
  // past ceil(len / T) nor past the table's width (positions beyond its
  // columns are absent, as in the reference); clamped before the first
  // fetch
  const int last_row = min(row0 + tile, n_rows) - 1;
  const int newest = len - n_q + last_row / hq;
  const int live_pages = (len + page_tokens - 1) / page_tokens;
  const int page_end =
      newest < 0 ? 0
                 : min(min(live_pages, newest / page_tokens + 1), table_width);

  // start the copy of table entry pi's raw tiles into the raw buffer
  auto fetch = [&](int pi) {
    const size_t page = size_t(page_table[size_t(b) * table_width + pi]);
    prefetch(c_pages + page * page_tokens * R, c_raw,
             page_tokens * R * int(sizeof(KV)));
    prefetch(kr_pages + page * page_tokens * DR, kr_raw,
             page_tokens * DR * int(sizeof(KV)));
    if constexpr (kQuant) {
      prefetch(c_scale + page * page_tokens, cs_raw, page_tokens * 4);
      prefetch(kr_scale + page * page_tokens, krs_raw, page_tokens * 4);
    }
    cp_async_commit();
  };

  if (page_end > 0) fetch(0);
  for (int pi = 0; pi < page_end; ++pi) {
    cp_async_wait_all();
    // page pi's raw tiles have landed (every thread's copies); every warp
    // is done with page pi - 1's f32 tiles
    __syncthreads();
    widen<KV, R>(c_raw, cs_raw, c_s, page_tokens);
    widen<KV, DR>(kr_raw, krs_raw, kr_s, page_tokens);
    __syncthreads();  // the f32 tiles are ready; the raw buffer is free
    if (pi + 1 < page_end) fetch(pi + 1);  // lands while this page computes

    for (int t0 = 0; t0 < page_tokens; t0 += G) {
      float s[RPW][G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        float4 cv[RC];
        float2 kv[DC];
#pragma unroll
        for (int k = 0; k < RC; ++k)
          cv[k] = reinterpret_cast<const float4*>(c_s + (t0 + u) * R +
                                                  k * 128)[lane];
#pragma unroll
        for (int k = 0; k < DC; ++k)
          kv[k] = reinterpret_cast<const float2*>(kr_s + (t0 + u) * DR +
                                                  k * 64)[lane];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          float part = 0.f;
#pragma unroll
          for (int k = 0; k < RC; ++k) {
            part = fmaf(ql[i][k].x, cv[k].x, part);
            part = fmaf(ql[i][k].y, cv[k].y, part);
            part = fmaf(ql[i][k].z, cv[k].z, part);
            part = fmaf(ql[i][k].w, cv[k].w, part);
          }
#pragma unroll
          for (int k = 0; k < DC; ++k) {
            part = fmaf(qr[i][k].x, kv[k].x, part);
            part = fmaf(qr[i][k].y, kv[k].y, part);
          }
          s[i][u] = part;
        }
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        float mx = m[i];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          // keep is uniform across the warp (one row per warp at a time)
          const bool keep = pi * page_tokens + t0 + u <= qpos[i];
          s[i][u] = keep ? warp_sum(s[i][u]) : kNegInf;
          mx = fmaxf(mx, s[i][u]);
        }
        const float corr = expf(m[i] - mx);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const bool keep = pi * page_tokens + t0 + u <= qpos[i];
          s[i][u] = keep ? expf(s[i][u] - mx) : 0.f;  // now p
          psum += s[i][u];
        }
        l[i] = l[i] * corr + psum;
        m[i] = mx;
#pragma unroll
        for (int k = 0; k < RC; ++k) {
          acc[i][k].x *= corr;
          acc[i][k].y *= corr;
          acc[i][k].z *= corr;
          acc[i][k].w *= corr;
        }
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        float4 cv[RC];
#pragma unroll
        for (int k = 0; k < RC; ++k)
          cv[k] = reinterpret_cast<const float4*>(c_s + (t0 + u) * R +
                                                  k * 128)[lane];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
#pragma unroll
          for (int k = 0; k < RC; ++k) {
            acc[i][k].x = fmaf(s[i][u], cv[k].x, acc[i][k].x);
            acc[i][k].y = fmaf(s[i][u], cv[k].y, acc[i][k].y);
            acc[i][k].z = fmaf(s[i][u], cv[k].z, acc[i][k].z);
            acc[i][k].w = fmaf(s[i][u], cv[k].w, acc[i][k].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + warp * RPW + i;
    if (r >= n_rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* o = out + (size_t(b) * n_rows + r) * R;
#pragma unroll
    for (int k = 0; k < RC; ++k)
      reinterpret_cast<float4*>(o + k * 128)[lane] =
          make_float4(acc[i][k].x * inv, acc[i][k].y * inv,
                      acc[i][k].z * inv, acc[i][k].w * inv);
  }
}

// Whether the kernel takes these shapes (the Python wrappers check first).
inline bool shapes_ok(int latent, int rope, int page_tokens,
                      size_t elem_bytes) {
  return latent == 512 && rope == 64 && page_tokens > 0 &&
         page_tokens % 8 == 0 &&
         smem_bytes(page_tokens, latent, rope, elem_bytes) <= 232448;
}

// Row tiling: few rows (decode) put one row on a warp, spreading them over
// more blocks; many rows (prefill chunks) put four on a warp.
inline bool one_row_per_warp(int n_q, int hq) { return n_q * hq <= 64; }

template <int RPW>
inline dim3 grid_of(int batch, int n_q, int hq) {
  const int tile = kWarps * RPW;
  return dim3((n_q * hq + tile - 1) / tile, batch);
}

}  // namespace mla
