// Paged multi-token attention for Hopper (sm_90a): bf16 in and out, f32 math.
//
// Replaces: k8s_runpod_kubelet_tpu/ops/attention.py:_paged_fwd_multi_kernel
// (launched by _paged_attention_multi_pallas). Launched at K = 1 it is also
// the port of _paged_fwd_kernel (launched by _paged_attention_pallas), the
// single-token decode form, which computes the same function with K = 1.
// The function, masks and contracts are stated in paged_attention_multi.cuh,
// whose kernel body this source instantiates for bf16 K/V pages.
//
// What bounds it on an H100: bytes. Decode (K=1) reads every live K/V page
// once per (sequence, kv head) and does 4 flops per byte read, far below the
// ~295 flop/byte at which the bf16 tensor cores would be the limit. A long
// prefill chunk (K up to 1024) re-reads the same pages for every row tile,
// so its flops grow with K while its bytes do not; this first version runs
// those flops on the CUDA cores in f32, which bounds it by operations there.
//
// Design: see paged_attention_multi.cuh. One block per (sequence, kv head,
// tile of query rows) walks the visible pages, staging each page's K and V
// tiles in shared memory once for all its rows, with the online-softmax
// state in registers.

#include "paged_attention_multi.cuh"

namespace {

template <int D, int RPW>
__global__ void __launch_bounds__(paged::kThreads)
paged_attention_multi_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k_pages,
                             const __nv_bfloat16* __restrict__ v_pages,
                             const int32_t* __restrict__ page_table,
                             const int32_t* __restrict__ lengths,
                             __nv_bfloat16* __restrict__ out, int n_q, int hq,
                             int hkv, int page_tokens, int table_width,
                             float scale, float soft_cap, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  paged::attend<__nv_bfloat16, D, RPW>(
      q, k_pages, v_pages, nullptr, nullptr, page_table, lengths, out, n_q,
      hq, hkv, page_tokens, table_width, scale, soft_cap, window, smem_raw);
}

template <int D, int RPW>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* lens, void* out, int batch, int n_q, int hq, int hkv,
           int page_tokens, int table_width, float scale, float soft_cap,
           int window, cudaStream_t stream) {
  const size_t smem = paged::smem_bytes<__nv_bfloat16, D>(page_tokens);
  paged_attention_multi_kernel<D, RPW>
      <<<paged::grid_of<RPW>(batch, n_q, hq, hkv), paged::kThreads, smem,
         stream>>>(static_cast<const __nv_bfloat16*>(q),
                   static_cast<const __nv_bfloat16*>(k),
                   static_cast<const __nv_bfloat16*>(v),
                   static_cast<const int32_t*>(pt),
                   static_cast<const int32_t*>(lens),
                   static_cast<__nv_bfloat16*>(out), n_q, hq, hkv,
                   page_tokens, table_width, scale, soft_cap, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* pt,
             const void* lens, void* out, int batch, int n_q, int hq, int hkv,
             int page_tokens, int table_width, float scale, float soft_cap,
             int window, cudaStream_t stream) {
  if (paged::one_row_per_warp(n_q, hq, hkv))
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
  if (!paged::shapes_ok(hq, hkv, head_dim, page_tokens, 2))
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
