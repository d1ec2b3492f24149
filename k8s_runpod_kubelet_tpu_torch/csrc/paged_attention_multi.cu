// Paged multi-token attention for Hopper (sm_90a): bf16 in and out, f32 math.
//
// Replaces: k8s_runpod_kubelet_tpu/ops/attention.py:_paged_fwd_multi_kernel
// (launched by _paged_attention_multi_pallas). Same function:
//   q (B, K, Hq, D) attends the K/V pages (P, T, Hkv, D) its page_table row
//   (B, N) names. lengths (B,) counts valid tokens INCLUDING the K new ones;
//   query j sits at position lengths - K + j and sees positions <= that
//   (causal inside the block). GQA group = Hq / Hkv. The optional soft cap
//   (cap * tanh(s / cap)) applies before the mask; the optional window keeps
//   positions in (qpos - window, qpos] and skips pages behind the window of
//   the block's OLDEST query; masked probabilities are zeroed explicitly.
//   Table entries at or after ceil(lengths / T) are never read.
//
// What bounds it on an H100: bytes. Decode (K=1) reads every live K/V page
// once per (sequence, kv head) and does 4 flops per byte read, far below the
// ~295 flop/byte at which the bf16 tensor cores would be the limit. A long
// prefill chunk (K up to 1024) re-reads the same pages for every row tile,
// so its flops grow with K while its bytes do not; this first version runs
// those flops on the CUDA cores in f32, which bounds it by operations there.
//
// Design: the TPU kernel walks pages as a sequential grid axis and carries
// the online-softmax state in VMEM scratch between grid steps. Hopper runs
// blocks in no order, so the page walk moves inside the block: one block per
// (sequence, kv head, tile of query rows), rows ordered query-major
// (row = j * group + g, as _paged_multi_q stacks them), each warp owning
// RPW rows whose softmax state (max, sum, D-wide accumulator) stays in
// registers. Per page the block stages the T x D K and V tiles in shared
// memory once for all its rows, and walks only the pages its newest row can
// see. Each lane holds D/32 contiguous elements of a row; a score is a lane
// partial dot plus a warp butterfly sum. Split-KV for small decode batches,
// wgmma and TMA are left to later work; this version is the simple, exact one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;            // positions per online-softmax update
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF

template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* out) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(p2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D, int RPW>
__global__ void __launch_bounds__(kThreads)
paged_attention_multi_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k_pages,
                             const __nv_bfloat16* __restrict__ v_pages,
                             const int32_t* __restrict__ page_table,
                             const int32_t* __restrict__ lengths,
                             __nv_bfloat16* __restrict__ out,
                             int n_q, int hq, int hkv, int page_tokens,
                             int table_width, float scale, float soft_cap,
                             int window) {
  constexpr int DPL = D / 32;  // elements of a row each lane holds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + page_tokens * D;

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
      load_bf16<DPL>(q + off, qr[i]);
#pragma unroll
      for (int d = 0; d < DPL; ++d) qr[i][d] *= scale;
    }
  }

  // pages this block reads: up to the page of its newest query, never at or
  // past ceil(len / T); with a window, none wholly behind its oldest query's
  const int last_row = min(row0 + tile, n_rows) - 1;
  const int newest = len - n_q + last_row / group;
  const int live_pages = (len + page_tokens - 1) / page_tokens;
  const int page_end =
      newest < 0 ? 0 : min(live_pages, newest / page_tokens + 1);
  int page_begin = 0;
  if (window > 0) {
    const int floor_pos = len - n_q + row0 / group - window + 1;
    if (floor_pos > 0) page_begin = floor_pos / page_tokens;
  }

  const int vec_per_row = D / 8;  // 16-byte vectors per position row
  for (int pi = page_begin; pi < page_end; ++pi) {
    const size_t page = size_t(page_table[size_t(b) * table_width + pi]);
    __syncthreads();  // every warp is done with the previous page's tiles
    for (int idx = threadIdx.x; idx < page_tokens * vec_per_row;
         idx += kThreads) {
      const int t = idx / vec_per_row;
      const int c = idx % vec_per_row;
      const size_t src = ((page * page_tokens + t) * hkv + h) * D + c * 8;
      reinterpret_cast<uint4*>(k_s + t * D)[c] =
          *reinterpret_cast<const uint4*>(k_pages + src);
      reinterpret_cast<uint4*>(v_s + t * D)[c] =
          *reinterpret_cast<const uint4*>(v_pages + src);
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
          load_bf16<DPL>(k_s + t * D + lane * DPL, kv);
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
          load_bf16<DPL>(v_s + (t0 + u) * D + lane * DPL, vv);
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

template <int D, int RPW>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* lens, void* out, int batch, int n_q, int hq, int hkv,
           int page_tokens, int table_width, float scale, float soft_cap,
           int window, cudaStream_t stream) {
  const int n_rows = n_q * (hq / hkv);
  const int tile = kWarps * RPW;
  const dim3 grid((n_rows + tile - 1) / tile, hkv, batch);
  const size_t smem = 2 * size_t(page_tokens) * D * sizeof(__nv_bfloat16);
  paged_attention_multi_kernel<D, RPW><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int32_t*>(pt), static_cast<const int32_t*>(lens),
      static_cast<__nv_bfloat16*>(out), n_q, hq, hkv, page_tokens,
      table_width, scale, soft_cap, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* pt,
             const void* lens, void* out, int batch, int n_q, int hq, int hkv,
             int page_tokens, int table_width, float scale, float soft_cap,
             int window, cudaStream_t stream) {
  // few rows (decode): one row per warp spreads them over more blocks;
  // many rows (prefill chunks): four per warp share each staged page
  if (n_q * (hq / hkv) <= 16)
    return launch<D, 1>(q, k, v, pt, lens, out, batch, n_q, hq, hkv,
                        page_tokens, table_width, scale, soft_cap, window,
                        stream);
  return launch<D, 4>(q, k, v, pt, lens, out, batch, n_q, hq, hkv,
                      page_tokens, table_width, scale, soft_cap, window,
                      stream);
}

}  // namespace

// C entry point bound by ops/attention.py through ctypes. Returns 0 or a
// cudaError_t code; cudaErrorInvalidValue for shapes the kernel does not
// take (the Python wrapper rejects those before calling).
extern "C" int paged_attention_multi_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, int batch,
    int n_q, int hq, int hkv, int head_dim, int page_tokens, int table_width,
    float scale, float soft_cap, int window, void* stream) {
  if (batch == 0 || n_q == 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || page_tokens % kGroup != 0 ||
      page_tokens * head_dim > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_d<64>(q, k_pages, v_pages, page_table, lengths, out,
                          batch, n_q, hq, hkv, page_tokens, table_width,
                          scale, soft_cap, window, s);
    case 128:
      return launch_d<128>(q, k_pages, v_pages, page_table, lengths, out,
                           batch, n_q, hq, hkv, page_tokens, table_width,
                           scale, soft_cap, window, s);
    case 256:
      return launch_d<256>(q, k_pages, v_pages, page_table, lengths, out,
                           batch, n_q, hq, hkv, page_tokens, table_width,
                           scale, soft_cap, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
