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
// split each sequence's pages into contiguous ranges (split-KV,
// paged_attention_split.cuh), merged by paged_attention_merge_kernel.

#include "paged_attention_split.cuh"

namespace {

using paged::bf16;
using paged::Paged;
using tile90::kRows;
using tile90::kWarpgroup;

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

struct Args {
  const void *q, *k, *v, *pt, *lens;
  void *out, *part_o, *part_ml;
  int batch;
};

template <int D, int WG, bool kSplit>
struct Launch {
  static int run(const Args& a, const Paged& p, cudaStream_t stream) {
    constexpr int BN = D == 256 ? 32 : 64;
    return paged::launch<D, WG, kSplit>(
        paged_attention_multi_kernel<D, BN, WG, kSplit>,
        tile90::smem_bytes<D, BN, WG>(), a.batch, p, a.out, a.part_o,
        a.part_ml, stream, static_cast<const bf16*>(a.q),
        static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
        static_cast<const int32_t*>(a.pt),
        static_cast<const int32_t*>(a.lens));
  }
};

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
  return paged::run<Launch, false>(
      Args{q, k_pages, v_pages, page_table, lengths, out, nullptr, nullptr,
           batch},
      batch, head_dim, 2,
      Paged{n_q, hq, hkv, page_tokens, table_width, scale, soft_cap, window,
            1, table_width > 0 ? table_width : 1},
      stream);
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
  return paged::run<Launch, true>(
      Args{q, k_pages, v_pages, page_table, lengths, out, part_o, part_ml,
           batch},
      batch, head_dim, 2,
      Paged{n_q, hq, hkv, page_tokens, table_width, scale, soft_cap, window,
            n_splits, pages_per_split},
      stream);
}
