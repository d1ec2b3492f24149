// Paged multi-token MLA latent attention over int8 latent pages for Hopper
// (sm_90a) on the tensor cores: f32 absorbed queries, int8 c/kr pages with
// per-position f32 scales, f32 sums and f32 output.
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
// bf16 tensor operations for prefill chunks.
//
// Design: the body of paged_attention_mla.cuh, instantiated for int8 pages.
// The TPU kernel dequantizes in score space, (q . c) * s for the scores and
// (p * s) . c for the output, because a (T, 1) scale column does not tile
// there; here too: the int8 values, exact as bf16 integers, are the
// tensor cores' B operand (staged raw by cp.async with their scales and
// widened in shared memory, the arena keeping its bytes), the scales
// multiply each key's column of S after the products (the latent and the
// rope part each by its own), and P is multiplied by the c scale before
// P c. The result differs from the reference's (int8 * scale) . c by f32
// rounding only. Only pages below ceil(len / T) are read: the sink page and
// stale table entries never are.

#include "paged_attention_mla.cuh"

namespace {

__global__ void __launch_bounds__(mla::kThreads, 1)
paged_attention_multi_mla_quant_kernel(const float* __restrict__ q_lat,
                                 const float* __restrict__ q_rope,
                                 const int8_t* __restrict__ c_pages,
                                 const int8_t* __restrict__ kr_pages,
                                 const float* __restrict__ c_scale,
                                 const float* __restrict__ kr_scale,
                                 const int32_t* __restrict__ page_table,
                                 const int32_t* __restrict__ lengths,
                                 float* __restrict__ out,
                                 float* __restrict__ part_o,
                                 float* __restrict__ part_ml,
                                 mla::Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  mla::attend<int8_t>(q_lat, q_rope, c_pages, kr_pages, c_scale, kr_scale,
                      page_table, lengths, out, part_o, part_ml, p, smem);
}

int run(const void* q_lat, const void* q_rope, const void* c_pages,
        const void* kr_pages, const void* c_scale, const void* kr_scale,
        const void* page_table, const void* lengths,
        void* out, void* part_o, void* part_ml, int batch, int n_q, int hq,
        int latent, int rope, int page_tokens, int table_width, float scale,
        int n_splits, int pages_per_split, void* stream) {
  if (batch == 0 || n_q == 0 || hq == 0) return 0;
  if (!mla::shapes_ok(latent, rope, page_tokens) || n_splits < 1 ||
      pages_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const mla::Params p{n_q,   hq,       page_tokens,    table_width,
                      scale, n_splits, pages_per_split};
  return mla::launch(
      paged_attention_multi_mla_quant_kernel, mla::smem_bytes<true>(), batch,
      p,
      static_cast<float*>(out), static_cast<const float*>(part_o),
      static_cast<const float*>(part_ml), static_cast<cudaStream_t>(stream),
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const int8_t*>(c_pages),
      static_cast<const int8_t*>(kr_pages),
      static_cast<const float*>(c_scale), static_cast<const float*>(kr_scale),
      static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(lengths), static_cast<float*>(out),
      static_cast<float*>(part_o), static_cast<float*>(part_ml));
}

}  // namespace

// C entry points bound by ops/attention.py through ctypes. Each returns 0
// or a cudaError_t code; cudaErrorInvalidValue for shapes the kernel does
// not take (the Python wrapper rejects those before calling).
//
// One pass, each block over all its pages:
extern "C" int paged_attention_multi_mla_int8(
    const void* q_lat, const void* q_rope, const void* c_pages,
    const void* kr_pages, const void* c_scale, const void* kr_scale,
    const void* page_table, const void* lengths,
    void* out, int batch, int n_q, int hq, int latent, int rope,
    int page_tokens, int table_width, float scale, void* stream) {
  return run(q_lat, q_rope, c_pages, kr_pages, c_scale, kr_scale,
             page_table, lengths, out,
             nullptr, nullptr, batch, n_q, hq, latent, rope, page_tokens,
             table_width, scale, 1, table_width > 0 ? table_width : 1,
             stream);
}

// Split-KV: each sequence's pages in ranges of pages_per_split, n_splits
// blocks a (sequence, row tile), then the merge. part_o (B, n_splits, K,
// Hq, R) and part_ml (B, n_splits, K, Hq, 2) f32 are scratch the caller
// allocated.
extern "C" int paged_attention_multi_mla_int8_split(
    const void* q_lat, const void* q_rope, const void* c_pages,
    const void* kr_pages, const void* c_scale, const void* kr_scale,
    const void* page_table, const void* lengths,
    void* out, void* part_o, void* part_ml, int batch, int n_q, int hq,
    int latent, int rope, int page_tokens, int table_width, float scale,
    int n_splits, int pages_per_split, void* stream) {
  return run(q_lat, q_rope, c_pages, kr_pages, c_scale, kr_scale,
             page_table, lengths, out,
             part_o, part_ml, batch, n_q, hq, latent, rope, page_tokens,
             table_width, scale, n_splits, pages_per_split, stream);
}
