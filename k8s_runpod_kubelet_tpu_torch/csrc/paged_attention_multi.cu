// Paged multi-token attention for Hopper (sm_90a) on the tensor cores: bf16
// in and out, f32 softmax and accumulation.
//
// Replaces: k8s_runpod_kubelet_tpu/ops/attention.py:_paged_fwd_multi_kernel
// (launched by _paged_attention_multi_pallas). Launched at K = 1 it is also
// the port of _paged_fwd_kernel (launched by _paged_attention_pallas), the
// single-token decode form, which computes the same function with K = 1.
//
// Function: q (B, K, Hq, D) attends the K/V pages (P, T, Hkv, D) its
// page_table row (B, N) names. lengths (B,) counts valid tokens INCLUDING
// the K new ones; query j sits at position lengths - K + j and sees
// positions <= that (causal inside the block). GQA group = Hq / Hkv. The
// optional soft cap (cap * tanh(s / cap)) applies before the mask; the
// optional window keeps positions in (qpos - window, qpos] and skips pages
// behind the window of the block's OLDEST query; masked probabilities are
// zeroed explicitly. Table entries at or after ceil(lengths / T) are never
// read.
//
// What bounds it on an H100: bytes at decode (K = 1 reads every live K/V
// page once per (sequence, kv head) for 4 flops a byte, far below the ~295
// at which the bf16 tensor cores are the limit); operations in a long
// prefill chunk (K up to 1024 re-reads the same pages for every row tile).
//
// Design: the TPU kernel walks pages as a sequential grid axis and carries
// the online-softmax state in VMEM between grid steps; here the walk is a
// loop inside the block, on the tile body of attention_tile_sm90.cuh. A
// block owns one (sequence, kv head, tile of 64 or 128 query rows): rows are
// position-major x group (row = j * group + g, as _paged_multi_q stacks
// them), padded to the tile. Its K/V tiles of 64 positions are gathered
// page by page through the block's page-table row by 16-byte cp.async into
// the swizzled layout (a head's T rows of a page sit at stride Hkv * D),
// positions past the block's newest query zero-filled. Decode gives few
// blocks (8 sequences x 8 kv heads = 64 on 132 SMs), so the wrapper may
// split each sequence's pages into contiguous ranges (split-KV): each split
// writes its rows' unnormalised f32 accumulator, max and sum to scratch the
// wrapper allocated, and paged_attention_merge_kernel combines the splits by
// their maxima and casts to bf16 (a split that saw no key carries max -1e30
// and sum 0 and weighs nothing).

#include "attention_tile_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tile90::kRows;
using tile90::kWarpgroup;

struct Paged {
  int n_q, hq, hkv, page_tokens, table_width;
  float scale, soft_cap;  // soft_cap <= 0: none
  int window;             // <= 0: none
  int n_splits, pages_per_split;
};

template <int D, int BN, int WG, bool kSplit>
__global__ void __launch_bounds__(WG * kWarpgroup, 1)
paged_attention_multi_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k_pages,
                             const bf16* __restrict__ v_pages,
                             const int32_t* __restrict__ page_table,
                             const int32_t* __restrict__ lengths,
                             bf16* __restrict__ out,
                             float* __restrict__ part_o,
                             float* __restrict__ part_ml, Paged p) {
  constexpr int BM = kRows * WG;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int b = blockIdx.z / p.n_splits;
  const int split = blockIdx.z % p.n_splits;
  const int h = blockIdx.y;
  const int group = p.hq / p.hkv;
  const int n_rows = p.n_q * group;
  const int row0 = blockIdx.x * BM;
  const int T = p.page_tokens;
  const int len = lengths[b];
  const int first_q = len - p.n_q;  // position of query 0

  tile90::Rows<D> st;
  st.init();
  const int wg_row0 = row0 + (threadIdx.x / kWarpgroup) * kRows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wg_row0 + tile90::Rows<D>::row(i);
    const int qpos = first_q + r / group;
    st.hi[i] = r < n_rows ? qpos : -1;
    st.lo[i] = p.window > 0 ? qpos - p.window + 1 : 0;
  }

  // pages this block reads: up to the page of its newest query, never at or
  // past ceil(len / T) nor past the table's width (positions beyond its
  // columns are absent, as in the reference); with a window, none wholly
  // behind its oldest query's; then this split's range of them
  const int newest = first_q + (min(row0 + BM, n_rows) - 1) / group;
  const int oldest = first_q + row0 / group;
  const int live = (len + T - 1) / T;
  const int page_end =
      newest < 0 ? 0 : min(min(live, newest / T + 1), p.table_width);
  int page_begin = 0;
  if (p.window > 0 && oldest - p.window + 1 > 0)
    page_begin = (oldest - p.window + 1) / T;
  const int sp0 = page_begin + split * p.pages_per_split;
  const int sp1 = min(page_end, sp0 + p.pages_per_split);
  const int key_begin = sp0 * T;
  const int key_end = min(sp1 * T, newest + 1);
  const int n_tiles =
      key_end > key_begin ? (key_end - key_begin + BN - 1) / BN : 0;
  // the zero-filled keys of the last tile past this split's range are not
  // the rows' to see (a later split's positions may lie below their hi)
#pragma unroll
  for (int i = 0; i < 2; ++i) st.hi[i] = min(st.hi[i], key_end - 1);

  const int32_t* table = page_table + size_t(b) * p.table_width;
  const long long q_seq = static_cast<long long>(b) * p.n_q;
  const int hq = p.hq, hkv = p.hkv;
  tile90::attend<D, BN, WG>(
      st, smem, q,
      [=](int r) -> long long {
        const int row = row0 + r;
        if (row >= n_rows) return -1;
        return ((q_seq + row / group) * hq + h * group + row % group) * D;
      },
      k_pages, v_pages,
      [=](int pos) -> long long {
        if (pos >= key_end) return -1;
        const long long page = table[pos / T];
        return ((page * T + pos % T) * hkv + h) * D;
      },
      key_begin, n_tiles, p.scale, p.soft_cap);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wg_row0 + tile90::Rows<D>::row(i);
    const float l = tile90::quad_sum(st.l[i]);
    if (r >= n_rows) continue;
    const size_t orow =
        (size_t(b) * p.n_q + r / group) * p.hq + h * group + r % group;
    if constexpr (!kSplit) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      bf16* o = out + orow * D;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8)
        *reinterpret_cast<__nv_bfloat162*>(o + tile90::Rows<D>::col(n8, 0)) =
            __floats2bfloat162_rn(st.o[n8 * 4 + i * 2] * inv,
                                  st.o[n8 * 4 + i * 2 + 1] * inv);
    } else {
      // scratch (B, splits, K, Hq, .): this split's row of the output
      const size_t prow =
          (size_t(b) * p.n_splits + split) * p.n_q * p.hq +
          (orow - size_t(b) * p.n_q * p.hq);
      float* o = part_o + prow * D;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8)
        *reinterpret_cast<float2*>(o + tile90::Rows<D>::col(n8, 0)) =
            make_float2(st.o[n8 * 4 + i * 2], st.o[n8 * 4 + i * 2 + 1]);
      if (threadIdx.x % 4 == 0)
        *reinterpret_cast<float2*>(part_ml + prow * 2) =
            make_float2(st.m[i], l);
    }
  }
}

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

template <int D, int WG, bool kSplit>
int launch(const void* q, const void* k, const void* v, const void* pt,
           const void* lens, void* out, void* part_o, void* part_ml,
           int batch, const Paged& p, cudaStream_t stream) {
  constexpr int BN = D == 256 ? 32 : 64;
  constexpr int BM = kRows * WG;
  const size_t smem = tile90::smem_bytes<D, BN, WG>();
  auto kernel = paged_attention_multi_kernel<D, BN, WG, kSplit>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rows = p.n_q * (p.hq / p.hkv);
  const dim3 grid((n_rows + BM - 1) / BM, p.hkv, batch * p.n_splits);
  kernel<<<grid, WG * kWarpgroup, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(lens), static_cast<bf16*>(out),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), p);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kSplit) return static_cast<int>(err);
  const int rows = batch * p.n_q * p.hq;
  paged_attention_merge_kernel<D><<<(rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<bf16*>(out), rows, p.n_q * p.hq, p.n_splits);
  return static_cast<int>(cudaGetLastError());
}

// one warpgroup a block when a sequence's rows fit in 64 (decode, short
// speculative blocks), two when they do not (prefill chunks share each
// staged tile between 128 rows)
template <int D, bool kSplit>
int launch_d(const void* q, const void* k, const void* v, const void* pt,
             const void* lens, void* out, void* part_o, void* part_ml,
             int batch, const Paged& p, cudaStream_t stream) {
  if (p.n_q * (p.hq / p.hkv) <= kRows)
    return launch<D, 1, kSplit>(q, k, v, pt, lens, out, part_o, part_ml,
                                batch, p, stream);
  return launch<D, 2, kSplit>(q, k, v, pt, lens, out, part_o, part_ml, batch,
                              p, stream);
}

template <bool kSplit>
int dispatch(const void* q, const void* k, const void* v, const void* pt,
             const void* lens, void* out, void* part_o, void* part_ml,
             int batch, int head_dim, const Paged& p, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_d<64, kSplit>(q, k, v, pt, lens, out, part_o, part_ml,
                                  batch, p, stream);
    case 128:
      return launch_d<128, kSplit>(q, k, v, pt, lens, out, part_o, part_ml,
                                   batch, p, stream);
    case 256:
      return launch_d<256, kSplit>(q, k, v, pt, lens, out, part_o, part_ml,
                                   batch, p, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the shapes the wrapper admits: GQA, T a multiple of 8 with a page tile
// of at most 16 KB
bool shapes_ok(int hq, int hkv, int head_dim, int page_tokens) {
  return hkv > 0 && hq % hkv == 0 && page_tokens % 8 == 0 &&
         page_tokens * head_dim * 2 <= 16384;
}

Paged paged(int n_q, int hq, int hkv, int page_tokens, int table_width,
            float scale, float soft_cap, int window, int n_splits,
            int pages_per_split) {
  Paged p;
  p.n_q = n_q;
  p.hq = hq;
  p.hkv = hkv;
  p.page_tokens = page_tokens;
  p.table_width = table_width;
  p.scale = scale;
  p.soft_cap = soft_cap;
  p.window = window;
  p.n_splits = n_splits;
  p.pages_per_split = pages_per_split;
  return p;
}

}  // namespace

// C entry points bound by ops/attention.py through ctypes. Each returns 0
// or a cudaError_t code; cudaErrorInvalidValue for shapes the kernel does
// not take (the Python wrapper rejects those before calling).
//
// One pass, each block over all its pages:
extern "C" int paged_attention_multi_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, int batch,
    int n_q, int hq, int hkv, int head_dim, int page_tokens, int table_width,
    float scale, float soft_cap, int window, void* stream) {
  if (batch == 0 || n_q == 0) return 0;
  if (!shapes_ok(hq, hkv, head_dim, page_tokens))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false>(
      q, k_pages, v_pages, page_table, lengths, out, nullptr, nullptr, batch,
      head_dim,
      paged(n_q, hq, hkv, page_tokens, table_width, scale, soft_cap, window,
            1, table_width),
      static_cast<cudaStream_t>(stream));
}

// Split-KV: each sequence's pages in ranges of pages_per_split, n_splits
// blocks a (sequence, kv head, row tile), then the merge. part_o (B,
// n_splits, K, Hq, D) and part_ml (B, n_splits, K, Hq, 2) f32 are scratch
// the caller allocated.
extern "C" int paged_attention_multi_bf16_split(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* part_o,
    void* part_ml, int batch, int n_q, int hq, int hkv, int head_dim,
    int page_tokens, int table_width, float scale, float soft_cap,
    int window, int n_splits, int pages_per_split, void* stream) {
  if (batch == 0 || n_q == 0) return 0;
  if (!shapes_ok(hq, hkv, head_dim, page_tokens) || n_splits < 1 ||
      pages_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(
      q, k_pages, v_pages, page_table, lengths, out, part_o, part_ml, batch,
      head_dim,
      paged(n_q, hq, hkv, page_tokens, table_width, scale, soft_cap, window,
            n_splits, pages_per_split),
      static_cast<cudaStream_t>(stream));
}
