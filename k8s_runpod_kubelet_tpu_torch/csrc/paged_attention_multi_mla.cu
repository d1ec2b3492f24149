// Paged multi-token MLA latent attention for Hopper (sm_90a) on the tensor
// cores: f32 absorbed queries, latent pages in bf16 (the model's compute
// dtype), f32 sums and f32 output.
//
// Replaces: k8s_runpod_kubelet_tpu/ops/attention.py:
// _paged_fwd_multi_mla_kernel (launched by
// _paged_attention_multi_mla_pallas). Launched at K = 1 it is also the port
// of _paged_fwd_mla_kernel (launched by _paged_attention_mla_pallas), the
// single-token form, which computes the same function with K = 1. The
// function, the causal in-block mask and the page contract are those of
// paged_attention_mla.cuh, whose kernel body this source instantiates.
//
// What bounds it on an H100: at decode, bytes: a position costs (R + DR) *
// 2 = 1,152 bytes at R = 512, DR = 64, read once for all 32 heads; at B = 8
// and contexts of 252-881 that is ~5 MB, 1.5 us at 3.35 TB/s, so in
// practice latency (a page walk, split over the sequence's pages). Prefill
// chunks do (2 (R + DR) + 2 R) flops per visible (row, position) pair, 98
// us of bf16 tensor work at a 1024-token chunk behind a 100-token prefix;
// the hi + lo splits issue twice that.
//
// Design: see paged_attention_mla.cuh: a block of two warpgroups owns 64
// query rows (R split between them), wgmma S = q [c | kr]^T and O += P c on
// tiles of 32 keys staged by cp.async in two stages, q and P as bf16 hi +
// lo, split-KV with a merge when the row tiles are few. The output is the
// f32 weighted latent (B, K, Hq, R); R and DR are those of every MLA config
// the repo has (512, 64).

#include "paged_attention_mla.cuh"

namespace {

__global__ void __launch_bounds__(mla::kThreads, 1)
paged_attention_multi_mla_kernel(const float* __restrict__ q_lat,
                                 const float* __restrict__ q_rope,
                                 const __nv_bfloat16* __restrict__ c_pages,
                                 const __nv_bfloat16* __restrict__ kr_pages,
                                 const int32_t* __restrict__ page_table,
                                 const int32_t* __restrict__ lengths,
                                 float* __restrict__ out,
                                 float* __restrict__ part_o,
                                 float* __restrict__ part_ml,
                                 mla::Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  mla::attend<__nv_bfloat16>(q_lat, q_rope, c_pages, kr_pages, nullptr,
                             nullptr, page_table, lengths, out, part_o,
                             part_ml, p, smem);
}

int run(const void* q_lat, const void* q_rope, const void* c_pages,
        const void* kr_pages, const void* page_table, const void* lengths,
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
      paged_attention_multi_mla_kernel, mla::smem_bytes<false>(), batch, p,
      static_cast<float*>(out), static_cast<const float*>(part_o),
      static_cast<const float*>(part_ml), static_cast<cudaStream_t>(stream),
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const __nv_bfloat16*>(c_pages),
      static_cast<const __nv_bfloat16*>(kr_pages),
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
extern "C" int paged_attention_multi_mla_bf16(
    const void* q_lat, const void* q_rope, const void* c_pages,
    const void* kr_pages, const void* page_table, const void* lengths,
    void* out, int batch, int n_q, int hq, int latent, int rope,
    int page_tokens, int table_width, float scale, void* stream) {
  return run(q_lat, q_rope, c_pages, kr_pages, page_table, lengths, out,
             nullptr, nullptr, batch, n_q, hq, latent, rope, page_tokens,
             table_width, scale, 1, table_width > 0 ? table_width : 1,
             stream);
}

// Split-KV: each sequence's pages in ranges of pages_per_split, n_splits
// blocks a (sequence, row tile), then the merge. part_o (B, n_splits, K,
// Hq, R) and part_ml (B, n_splits, K, Hq, 2) f32 are scratch the caller
// allocated.
extern "C" int paged_attention_multi_mla_bf16_split(
    const void* q_lat, const void* q_rope, const void* c_pages,
    const void* kr_pages, const void* page_table, const void* lengths,
    void* out, void* part_o, void* part_ml, int batch, int n_q, int hq,
    int latent, int rope, int page_tokens, int table_width, float scale,
    int n_splits, int pages_per_split, void* stream) {
  return run(q_lat, q_rope, c_pages, kr_pages, page_table, lengths, out,
             part_o, part_ml, batch, n_q, hq, latent, rope, page_tokens,
             table_width, scale, n_splits, pages_per_split, stream);
}
