// Split-KV and the launch both paged multi-token attention kernels share:
// the bf16 kernel (paged_attention_multi.cu, pages in the compute dtype)
// and the int8-page kernel (paged_attention_multi_quant.cu). Each of those
// sources states the TPU kernel it replaces and the function it computes;
// both run on Hopper's tensor cores (sm_90a) on the primitives of
// attention_tile_sm90.cuh.
//
// A block owns one (sequence, kv head, tile of 64 WG query rows): rows are
// position-major x group (row = j * group + g, as _paged_multi_q stacks
// them), padded to the tile. Decode gives few blocks (8 sequences x 8 kv
// heads = 64 on 132 SMs), so the wrapper may split each sequence's pages
// into contiguous ranges planned from shapes alone (split-KV, the wrapper's
// _split_plan): each split writes its rows' unnormalised f32 accumulator,
// max and sum to scratch the wrapper allocated, and
// paged_attention_merge_kernel combines the splits by their maxima and
// casts to bf16 (a split that saw no key carries max -1e30 and sum 0 and
// weighs nothing).

#pragma once

#include "attention_tile_sm90.cuh"

namespace paged {

using bf16 = __nv_bfloat16;
using tile90::kRows;
using tile90::kWarpgroup;

struct Paged {
  int n_q, hq, hkv, page_tokens, table_width;
  float scale, soft_cap;  // soft_cap <= 0: none
  int window;             // <= 0: none
  int n_splits, pages_per_split;
};

// One warp per output row (b, j, head): the splits' accumulators weighted by
// exp2(max_s - max), divided by the weighted sum, cast to bf16. A row that
// saw no key in any split has every sum 0 and gets 0.
template <int D>
__global__ void __launch_bounds__(128)
paged_attention_merge_kernel(const float* __restrict__ part_o,
                             const float* __restrict__ part_ml,
                             bf16* __restrict__ out, int rows,
                             int rows_per_seq, int n_splits) {
  constexpr int E = D / 32;  // elements of the row each lane owns
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int b = row / rows_per_seq;
  const size_t first =
      size_t(b) * n_splits * rows_per_seq + row % rows_per_seq;
  float mx = tile90::kNegInf;
  for (int s = 0; s < n_splits; ++s)
    mx = fmaxf(mx, part_ml[(first + size_t(s) * rows_per_seq) * 2]);
  float acc[E] = {};
  float l = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const size_t prow = first + size_t(s) * rows_per_seq;
    const float w = exp2f(part_ml[prow * 2] - mx);
    l += w * part_ml[prow * 2 + 1];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += w * part_o[prow * D + lane + 32 * e];
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e)
    out[size_t(row) * D + lane + 32 * e] = __float2bfloat16(acc[e] * inv);
}

// One launch of kernel (an instantiation for D and WG, whose arguments end
// in out, part_o, part_ml and the Paged) and, when the pages are split, the
// merge. Returns 0 or a cudaError_t code.
template <int D, int WG, bool kSplit, class Kernel, class... Args>
int launch(Kernel kernel, size_t smem, int batch, const Paged& p, void* out,
           void* part_o, void* part_ml, cudaStream_t stream, Args... args) {
  constexpr int BM = kRows * WG;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rows = p.n_q * (p.hq / p.hkv);
  const dim3 grid((n_rows + BM - 1) / BM, p.hkv, batch * p.n_splits);
  kernel<<<grid, WG * kWarpgroup, smem, stream>>>(
      args..., static_cast<bf16*>(out), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), p);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kSplit) return static_cast<int>(err);
  const int rows = batch * p.n_q * p.hq;
  paged_attention_merge_kernel<D><<<(rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<bf16*>(out), rows, p.n_q * p.hq, p.n_splits);
  return static_cast<int>(cudaGetLastError());
}

// The launch of a C entry: nothing for an empty batch,
// cudaErrorInvalidValue for shapes the kernels do not take (GQA, T a
// multiple of 8 with a page tile of T x D elements of elem_bytes of at most
// 16 KB, D in {64, 128, 256}; the Python wrapper checks first), else
// L<D, WG, kSplit>::run(a, p, stream) with one warpgroup a block when a
// sequence's rows fit in 64 (decode, short speculative blocks) and two when
// they do not (prefill chunks share each staged tile between 128 rows).
template <template <int, int, bool> class L, bool kSplit, class A>
int run(const A& a, int batch, int head_dim, int elem_bytes, const Paged& p,
        void* stream) {
  if (batch == 0 || p.n_q == 0) return 0;
  if (p.hkv <= 0 || p.hq % p.hkv != 0 || p.page_tokens % 8 != 0 ||
      p.page_tokens * head_dim * elem_bytes > 16384 || p.n_splits < 1 ||
      p.pages_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one = p.n_q * (p.hq / p.hkv) <= kRows;
  switch (head_dim) {
    case 64:
      return one ? L<64, 1, kSplit>::run(a, p, s)
                 : L<64, 2, kSplit>::run(a, p, s);
    case 128:
      return one ? L<128, 1, kSplit>::run(a, p, s)
                 : L<128, 2, kSplit>::run(a, p, s);
    case 256:
      return one ? L<256, 1, kSplit>::run(a, p, s)
                 : L<256, 2, kSplit>::run(a, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace paged
