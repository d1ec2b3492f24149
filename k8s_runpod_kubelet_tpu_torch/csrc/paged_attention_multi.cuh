// The paged multi-token attention kernel body of
// paged_attention_multi_quant.cu (int8 K/V pages with f32 scales), which
// states the TPU kernel it replaces and instantiates this template behind
// its own __global__ kernel and C entry. (The bf16 kernel,
// paged_attention_multi.cu, runs on the tensor cores on the tile body of
// attention_tile_sm90.cuh instead; this body is f32 on the CUDA cores.)
//
// Function: q (B, K, Hq, D) attends the K/V pages (P, T, Hkv, D) its
// page_table row (B, N) names. lengths (B,) counts valid tokens INCLUDING
// the K new ones; query j sits at position lengths - K + j and sees
// positions <= that (causal inside the block). GQA group = Hq / Hkv. The
// optional soft cap (cap * tanh(s / cap)) applies before the mask; the
// optional window keeps positions in (qpos - window, qpos] and skips pages
// behind the window of the block's OLDEST query; masked probabilities are
// zeroed explicitly. Table entries at or after ceil(lengths / T) are never
// read. For int8 pages, position t of head h dequantizes as
// int8 * scale[page, t, h] in f32 right after the load from shared memory.
//
// Design: the TPU kernels walk pages as a sequential grid axis and carry
// the online-softmax state in VMEM scratch between grid steps. Hopper runs
// blocks in no order, so the page walk moves inside the block: one block per
// (sequence, kv head, tile of query rows), rows ordered query-major
// (row = j * group + g, as _paged_multi_q stacks them), each warp owning
// RPW rows whose softmax state (max, sum, D-wide accumulator) stays in
// registers. Per page the block stages the T x D K and V tiles (and, for
// int8 pages, the T scales of its head, which sit at stride Hkv) in shared
// memory once for all its rows, and walks only the pages its newest row can
// see. Each lane holds D/32 contiguous elements of a row; a score is a lane
// partial dot plus a warp butterfly sum. Split-KV for small decode batches,
// wgmma and TMA are left to later work; this version is the simple, exact
// one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace paged {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;            // positions per online-softmax update
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float,
                                         float* out) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(p2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// N int8 values (N a multiple of 2; 2-byte aligned) times their row's scale
template <int N>
__device__ __forceinline__ void load_row(const int8_t* p, float scale,
                                         float* out) {
  const char2* p2 = reinterpret_cast<const char2*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const char2 c = p2[i];
    out[2 * i] = static_cast<float>(c.x) * scale;
    out[2 * i + 1] = static_cast<float>(c.y) * scale;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of one block: the K and V tiles of a page, then (int8
// pages) the page's K and V scales of the block's head.
template <typename KV, int D>
constexpr size_t smem_bytes(int page_tokens) {
  return 2 * size_t(page_tokens) * D * sizeof(KV) +
         (std::is_same<KV, int8_t>::value ? 2 * size_t(page_tokens) * 4 : 0);
}

template <typename KV, int D, int RPW>
__device__ __forceinline__ void attend(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    int n_q, int hq, int hkv, int page_tokens, int table_width, float scale,
    float soft_cap, int window, unsigned char* smem_raw) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int DPL = D / 32;  // elements of a row each lane holds
  constexpr int kVec = 16 / sizeof(KV);  // elements per 16-byte vector
  KV* k_s = reinterpret_cast<KV*>(smem_raw);
  KV* v_s = k_s + page_tokens * D;
  float* ks_s = reinterpret_cast<float*>(v_s + page_tokens * D);
  float* vs_s = ks_s + page_tokens;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int group = hq / hkv;
  const int n_rows = n_q * group;
  const int tile = kWarps * RPW;
  const int row0 = blockIdx.x * tile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = lengths[b];

  float qr[RPW][DPL];
  float acc[RPW][DPL];
  float m[RPW];
  float l[RPW];
  int qpos[RPW];
  bool valid[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + warp * RPW + i;
    valid[i] = r < n_rows;  // uniform across the warp
    const int j = r / group;
    const int g = r % group;
    qpos[i] = len - n_q + j;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      acc[i][d] = 0.f;
      qr[i][d] = 0.f;
    }
    if (valid[i]) {
      const size_t off =
          ((size_t(b) * n_q + j) * hq + h * group + g) * D + lane * DPL;
      load_row<DPL>(q + off, 1.f, qr[i]);
#pragma unroll
      for (int d = 0; d < DPL; ++d) qr[i][d] *= scale;
    }
  }

  // pages this block reads: up to the page of its newest query, never at or
  // past ceil(len / T) nor past the table's width (positions beyond its
  // columns are absent, as in the reference); with a window, none wholly
  // behind its oldest query's
  const int last_row = min(row0 + tile, n_rows) - 1;
  const int newest = len - n_q + last_row / group;
  const int live_pages = (len + page_tokens - 1) / page_tokens;
  const int page_end =
      newest < 0 ? 0
                 : min(min(live_pages, newest / page_tokens + 1), table_width);
  int page_begin = 0;
  if (window > 0) {
    const int floor_pos = len - n_q + row0 / group - window + 1;
    if (floor_pos > 0) page_begin = floor_pos / page_tokens;
  }

  const int vec_per_row = D / kVec;  // 16-byte vectors per position row
  for (int pi = page_begin; pi < page_end; ++pi) {
    const size_t page = size_t(page_table[size_t(b) * table_width + pi]);
    __syncthreads();  // every warp is done with the previous page's tiles
    for (int idx = threadIdx.x; idx < page_tokens * vec_per_row;
         idx += kThreads) {
      const int t = idx / vec_per_row;
      const int c = idx % vec_per_row;
      const size_t src = ((page * page_tokens + t) * hkv + h) * D + c * kVec;
      reinterpret_cast<uint4*>(k_s + t * D)[c] =
          *reinterpret_cast<const uint4*>(k_pages + src);
      reinterpret_cast<uint4*>(v_s + t * D)[c] =
          *reinterpret_cast<const uint4*>(v_pages + src);
    }
    if constexpr (kQuant) {
      for (int t = threadIdx.x; t < page_tokens; t += kThreads) {
        const size_t src = (page * page_tokens + t) * hkv + h;
        ks_s[t] = k_scale[src];
        vs_s[t] = v_scale[src];
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (!valid[i]) continue;
      for (int t0 = 0; t0 < page_tokens; t0 += kGroup) {
        float s[kGroup];
        bool keep[kGroup];
        float mx = m[i];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int t = t0 + u;
          float kv[DPL];
          load_row<DPL>(k_s + t * D + lane * DPL, kQuant ? ks_s[t] : 1.f, kv);
          float part = 0.f;
#pragma unroll
          for (int d = 0; d < DPL; ++d) part = fmaf(qr[i][d], kv[d], part);
          float sc = warp_sum(part);
          if (soft_cap > 0.f) sc = tanhf(sc / soft_cap) * soft_cap;
          const int pos = pi * page_tokens + t;
          keep[u] = pos <= qpos[i] &&
                    (window <= 0 || pos > qpos[i] - window);
          s[u] = keep[u] ? sc : kNegInf;
          mx = fmaxf(mx, s[u]);
        }
        const float corr = expf(m[i] - mx);
        float psum = 0.f;
        float p[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          p[u] = keep[u] ? expf(s[u] - mx) : 0.f;
          psum += p[u];
        }
        l[i] = l[i] * corr + psum;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[i][d] *= corr;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          float vv[DPL];
          load_row<DPL>(v_s + (t0 + u) * D + lane * DPL,
                        kQuant ? vs_s[t0 + u] : 1.f, vv);
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[i][d] = fmaf(p[u], vv[d], acc[i][d]);
        }
        m[i] = mx;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (!valid[i]) continue;
    const int r = row0 + warp * RPW + i;
    const int j = r / group;
    const int g = r % group;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(
        out + ((size_t(b) * n_q + j) * hq + h * group + g) * D + lane * DPL);
#pragma unroll
    for (int d = 0; d < DPL / 2; ++d)
      o2[d] = __floats2bfloat162_rn(acc[i][2 * d] * inv,
                                    acc[i][2 * d + 1] * inv);
  }
}

// Whether the kernel takes these shapes (the Python wrappers check first).
inline bool shapes_ok(int hq, int hkv, int head_dim, int page_tokens,
                      size_t elem_bytes) {
  return hkv > 0 && hq % hkv == 0 && page_tokens % kGroup == 0 &&
         page_tokens * head_dim * elem_bytes <= 16384;
}

// Row tiling: few rows (decode) put one row on a warp, spreading them over
// more blocks; many rows (prefill chunks) put four on a warp, sharing each
// staged page.
inline bool one_row_per_warp(int n_q, int hq, int hkv) {
  return n_q * (hq / hkv) <= 16;
}

template <int RPW>
inline dim3 grid_of(int batch, int n_q, int hq, int hkv) {
  const int n_rows = n_q * (hq / hkv);
  const int tile = kWarps * RPW;
  return dim3((n_rows + tile - 1) / tile, hkv, batch);
}

}  // namespace paged
