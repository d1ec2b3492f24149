// Paged multi-token attention over int8 K/V pages for Hopper (sm_90a): bf16
// q and output, int8 pages with f32 per-(position, kv head) scales, f32 math.
//
// Replaces: k8s_runpod_kubelet_tpu/ops/attention.py:
// _paged_fwd_multi_quant_kernel (launched by
// _paged_attention_multi_quant_pallas). Launched at K = 1 it is also the
// port of _paged_fwd_quant_kernel (launched by
// _paged_attention_quant_pallas), the single-token form, which computes the
// same function with K = 1. The function of paged_attention_multi.cu over
// int8 pages k/v (P, T, Hkv, D) with scales (P, T, Hkv): kc = int8 *
// k_scale[page, t, h] and vc alike are formed in f32 after the load, as the
// TPU kernel does; the causal in-block mask, GQA, soft cap, window page skip
// and explicit zeroing under a window are those of
// paged_attention_multi.cuh, whose kernel body this source instantiates.
//
// What bounds it on an H100: bytes at decode: half of the bf16 kernel's K/V
// bytes, plus 4 bytes of scale per position and kv head for K and for V (at
// D = 128, 6% on top of the int8 payload). Prefill chunks re-read pages per
// row tile and run their flops on the CUDA cores in f32, as the bf16 kernel
// does, which bounds them by operations there.
//
// Design: the bf16 kernel's structure (one block per sequence, kv head and
// row tile; the page walk inside the block; online softmax in registers).
// Per page the block stages the T x D int8 K and V tiles with 16-byte loads
// (rows are D bytes, so D % 16 == 0 keeps them aligned) and the T scales of
// its head, which sit at stride Hkv in the scale page, in shared memory;
// each lane dequantizes its D/32 elements at the register load. Only pages
// below ceil(len / T) are read: the sink page and stale table entries never
// are.

#include "paged_attention_multi.cuh"

namespace {

template <int D, int RPW>
__global__ void __launch_bounds__(paged::kThreads)
paged_attention_multi_quant_kernel(const __nv_bfloat16* __restrict__ q,
                                   const int8_t* __restrict__ k_pages,
                                   const int8_t* __restrict__ v_pages,
                                   const float* __restrict__ k_scale,
                                   const float* __restrict__ v_scale,
                                   const int32_t* __restrict__ page_table,
                                   const int32_t* __restrict__ lengths,
                                   __nv_bfloat16* __restrict__ out, int n_q,
                                   int hq, int hkv, int page_tokens,
                                   int table_width, float scale,
                                   float soft_cap, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  paged::attend<int8_t, D, RPW>(q, k_pages, v_pages, k_scale, v_scale,
                                page_table, lengths, out, n_q, hq, hkv,
                                page_tokens, table_width, scale, soft_cap,
                                window, smem_raw);
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *pt, *lens;
  void* out;
  int batch, n_q, hq, hkv, page_tokens, table_width;
  float scale, soft_cap;
  int window;
};

template <int D, int RPW>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = paged::smem_bytes<int8_t, D>(a.page_tokens);
  paged_attention_multi_quant_kernel<D, RPW>
      <<<paged::grid_of<RPW>(a.batch, a.n_q, a.hq, a.hkv), paged::kThreads,
         smem, stream>>>(
          static_cast<const __nv_bfloat16*>(a.q),
          static_cast<const int8_t*>(a.k), static_cast<const int8_t*>(a.v),
          static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
          static_cast<const int32_t*>(a.pt),
          static_cast<const int32_t*>(a.lens),
          static_cast<__nv_bfloat16*>(a.out), a.n_q, a.hq, a.hkv,
          a.page_tokens, a.table_width, a.scale, a.soft_cap, a.window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Args& a, cudaStream_t stream) {
  if (paged::one_row_per_warp(a.n_q, a.hq, a.hkv))
    return launch<D, 1>(a, stream);
  return launch<D, 4>(a, stream);
}

}  // namespace

// C entry point bound by ops/attention.py through ctypes. Returns 0 or a
// cudaError_t code; cudaErrorInvalidValue for shapes the kernel does not
// take (the Python wrapper rejects those before calling).
extern "C" int paged_attention_multi_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lengths, void* out, int batch, int n_q, int hq, int hkv,
    int head_dim, int page_tokens, int table_width, float scale,
    float soft_cap, int window, void* stream) {
  if (batch == 0 || n_q == 0) return 0;
  if (!paged::shapes_ok(hq, hkv, head_dim, page_tokens, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,     k_pages,     v_pages, k_scale,  v_scale, page_table,
               lengths, out,       batch,   n_q,      hq,      hkv,
               page_tokens, table_width, scale, soft_cap, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_d<64>(a, s);
    case 128:
      return launch_d<128>(a, s);
    case 256:
      return launch_d<256>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
