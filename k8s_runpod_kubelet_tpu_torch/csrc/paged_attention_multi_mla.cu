// Paged multi-token MLA latent attention for Hopper (sm_90a): f32 absorbed
// queries, latent pages in bf16 (the model's compute dtype), f32 math and
// f32 output.
//
// Replaces: k8s_runpod_kubelet_tpu/ops/attention.py:
// _paged_fwd_multi_mla_kernel (launched by
// _paged_attention_multi_mla_pallas). Launched at K = 1 it is also the port
// of _paged_fwd_mla_kernel (launched by _paged_attention_mla_pallas), the
// single-token form, which computes the same function with K = 1. The
// function, the causal in-block mask and the page contract are those of
// paged_attention_mla.cuh, whose kernel body this source instantiates.
//
// What bounds it on an H100: at decode, bytes in principle: a position
// costs (R + DR) * 2 = 1,152 bytes at R = 512, DR = 64, read once for all
// 32 heads; at B = 8 and contexts of 252-881 that is ~5 MB, 1.5 us at 3.35
// TB/s, far below what a simple kernel reaches, so in practice latency (a
// page walk per block, a warp butterfly per score). Prefill chunks do
// (2 (R + DR) + 2 R) flops per visible (row, position) pair on the CUDA
// cores in f32, which bounds them by operations there.
//
// Design: see paged_attention_mla.cuh. Each block stages a page's c and kr
// tiles as f32 in shared memory once for its 4 (decode) or 16 (prefill)
// rows, while cp.async brings the next page's bf16 tiles beside them; at
// T = 16 that is 36 KB + 18 KB. The output is the f32 weighted latent
// (B, K, Hq, R); R and DR are template arguments, instantiated at the
// widths of every MLA config the repo has (R = 512, DR = 64).

#include "paged_attention_mla.cuh"

namespace {

template <int R, int DR, int RPW>
__global__ void __launch_bounds__(mla::kThreads)
paged_attention_multi_mla_kernel(const float* __restrict__ q_lat,
                                 const float* __restrict__ q_rope,
                                 const __nv_bfloat16* __restrict__ c_pages,
                                 const __nv_bfloat16* __restrict__ kr_pages,
                                 const int32_t* __restrict__ page_table,
                                 const int32_t* __restrict__ lengths,
                                 float* __restrict__ out, int n_q, int hq,
                                 int page_tokens, int table_width,
                                 float scale) {
  extern __shared__ __align__(16) float smem[];
  mla::attend<__nv_bfloat16, R, DR, RPW>(
      q_lat, q_rope, c_pages, kr_pages, nullptr, nullptr, page_table,
      lengths, out, n_q, hq, page_tokens, table_width, scale, smem);
}

struct Args {
  const void *q_lat, *q_rope, *c, *kr, *pt, *lens;
  void* out;
  int batch, n_q, hq, latent, rope, page_tokens, table_width;
  float scale;
};

template <int R, int DR, int RPW>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = mla::smem_bytes(a.page_tokens, R, DR, 2);
  auto kernel = paged_attention_multi_mla_kernel<R, DR, RPW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<mla::grid_of<RPW>(a.batch, a.n_q, a.hq), mla::kThreads, smem,
           stream>>>(
      static_cast<const float*>(a.q_lat), static_cast<const float*>(a.q_rope),
      static_cast<const __nv_bfloat16*>(a.c),
      static_cast<const __nv_bfloat16*>(a.kr),
      static_cast<const int32_t*>(a.pt), static_cast<const int32_t*>(a.lens),
      static_cast<float*>(a.out), a.n_q, a.hq, a.page_tokens, a.table_width,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point bound by ops/attention.py through ctypes. Returns 0 or a
// cudaError_t code; cudaErrorInvalidValue for shapes the kernel does not
// take (the Python wrapper rejects those before calling).
extern "C" int paged_attention_multi_mla_bf16(
    const void* q_lat, const void* q_rope, const void* c_pages,
    const void* kr_pages, const void* page_table, const void* lengths,
    void* out, int batch, int n_q, int hq, int latent, int rope,
    int page_tokens, int table_width, float scale, void* stream) {
  if (batch == 0 || n_q == 0 || hq == 0) return 0;
  if (!mla::shapes_ok(latent, rope, page_tokens, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q_lat, q_rope, c_pages, kr_pages, page_table, lengths, out,
               batch, n_q,    hq,      latent,   rope,       page_tokens,
               table_width, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mla::one_row_per_warp(n_q, hq)) return launch<512, 64, 1>(a, s);
  return launch<512, 64, 4>(a, s);
}
