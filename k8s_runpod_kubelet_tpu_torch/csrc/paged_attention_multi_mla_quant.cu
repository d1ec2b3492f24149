// Paged multi-token MLA latent attention over int8 latent pages for Hopper
// (sm_90a): f32 absorbed queries, int8 c/kr pages with per-position f32
// scales, f32 math and f32 output.
//
// Replaces: k8s_runpod_kubelet_tpu/ops/attention.py:
// _paged_fwd_multi_mla_quant_kernel (launched by
// _paged_attention_multi_mla_quant_pallas). Launched at K = 1 it is also
// the port of _paged_fwd_mla_quant_kernel (launched by
// _paged_attention_mla_quant_pallas), the single-token form, which computes
// the same function with K = 1. The function of paged_attention_multi_mla.cu
// over int8 pages c (P, T, R) and kr (P, T, DR) with scales c_scale and
// kr_scale (P, T): position t of a page stands for int8 * scale[page, t].
//
// What bounds it on an H100: as the bf16 kernel, with half its page bytes
// (R + DR = 576 bytes a position, plus 8 bytes of scales) at decode, and
// operations on the CUDA cores in f32 for prefill chunks.
//
// Design: the body of paged_attention_mla.cuh, instantiated for int8 pages.
// The TPU kernel dequantizes in score space, (q . c) * s for the scores and
// (p * s) . c for the output, because a (T, 1) scale column does not tile
// there. Here each position's scale is a scalar that multiplies its staged
// row once, where the raw int8 tile (brought in by cp.async with its two
// scale rows) widens into f32 shared memory, which all the block's rows
// then share: the cheapest place, and the reference's own order
// (dequantize, then attend). At T = 16 that is 36 KB + 9 KB. Only pages
// below ceil(len / T) are read: the sink page and stale table entries
// never are.

#include "paged_attention_mla.cuh"

namespace {

template <int R, int DR, int RPW>
__global__ void __launch_bounds__(mla::kThreads)
paged_attention_multi_mla_quant_kernel(const float* __restrict__ q_lat,
                                       const float* __restrict__ q_rope,
                                       const int8_t* __restrict__ c_pages,
                                       const int8_t* __restrict__ kr_pages,
                                       const float* __restrict__ c_scale,
                                       const float* __restrict__ kr_scale,
                                       const int32_t* __restrict__ page_table,
                                       const int32_t* __restrict__ lengths,
                                       float* __restrict__ out, int n_q,
                                       int hq, int page_tokens,
                                       int table_width, float scale) {
  extern __shared__ __align__(16) float smem[];
  mla::attend<int8_t, R, DR, RPW>(q_lat, q_rope, c_pages, kr_pages, c_scale,
                                  kr_scale, page_table, lengths, out, n_q, hq,
                                  page_tokens, table_width, scale, smem);
}

struct Args {
  const void *q_lat, *q_rope, *c, *kr, *cs, *krs, *pt, *lens;
  void* out;
  int batch, n_q, hq, latent, rope, page_tokens, table_width;
  float scale;
};

template <int R, int DR, int RPW>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = mla::smem_bytes(a.page_tokens, R, DR, 1);
  auto kernel = paged_attention_multi_mla_quant_kernel<R, DR, RPW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<mla::grid_of<RPW>(a.batch, a.n_q, a.hq), mla::kThreads, smem,
           stream>>>(
      static_cast<const float*>(a.q_lat), static_cast<const float*>(a.q_rope),
      static_cast<const int8_t*>(a.c), static_cast<const int8_t*>(a.kr),
      static_cast<const float*>(a.cs), static_cast<const float*>(a.krs),
      static_cast<const int32_t*>(a.pt), static_cast<const int32_t*>(a.lens),
      static_cast<float*>(a.out), a.n_q, a.hq, a.page_tokens, a.table_width,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point bound by ops/attention.py through ctypes. Returns 0 or a
// cudaError_t code; cudaErrorInvalidValue for shapes the kernel does not
// take (the Python wrapper rejects those before calling).
extern "C" int paged_attention_multi_mla_int8(
    const void* q_lat, const void* q_rope, const void* c_pages,
    const void* kr_pages, const void* c_scale, const void* kr_scale,
    const void* page_table, const void* lengths, void* out, int batch,
    int n_q, int hq, int latent, int rope, int page_tokens, int table_width,
    float scale, void* stream) {
  if (batch == 0 || n_q == 0 || hq == 0) return 0;
  if (!mla::shapes_ok(latent, rope, page_tokens, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q_lat,   q_rope,     c_pages, kr_pages, c_scale, kr_scale,
               page_table, lengths, out,     batch,    n_q,     hq,
               latent,  rope,       page_tokens, table_width, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mla::one_row_per_warp(n_q, hq)) return launch<512, 64, 1>(a, s);
  return launch<512, 64, 4>(a, s);
}
