// Paged multi-token attention over int8 K/V pages for Hopper (sm_90a) on
// the tensor cores: bf16 q and output, int8 pages with f32
// per-(position, kv head) scales, f32 softmax and accumulation.
//
// Replaces: k8s_runpod_kubelet_tpu/ops/attention.py:
// _paged_fwd_multi_quant_kernel (launched by
// _paged_attention_multi_quant_pallas). Launched at K = 1 it is also the
// port of _paged_fwd_quant_kernel (launched by
// _paged_attention_quant_pallas), the single-token form, which computes the
// same function with K = 1. The function of paged_attention_multi.cu over
// int8 pages k/v (P, T, Hkv, D) with scales (P, T, Hkv): position t of head
// h stands for int8 * scale[page, t, h], as the reference dequantizes it in
// f32 after the load.
//
// What bounds it on an H100: bytes at decode, half of the bf16 kernel's K/V
// bytes plus 4 bytes of scale per position and kv head for K and for V (at
// D = 128, 6% on top of the int8 payload); bf16 tensor operations in a long
// prefill chunk, which re-reads the same pages for every row tile.
//
// Design: the bf16 kernel's blocks and tiles (a block per sequence, kv
// head, tile of 64 or 128 query rows and split of the pages; 64-key tiles,
// 32 at D = 256), with the arena's int8 bytes kept as they are and the
// arithmetic exact:
//   staging  each tile's raw int8 K and V rows are gathered page by page by
//            16-byte cp.async (a head's rows sit at stride Hkv * D bytes),
//            its BN k- and v-scales (stride Hkv floats) by 4-byte cp.async,
//            into two raw stages (tile t + 2 lands while t computes); keys
//            past the split's end are zero-filled;
//   widen    the raw stage into the swizzled bf16 K and V stages of the tile
//            body: integers, exact in bf16, by integer ops and one bf16x2
//            subtract (i8_bf16); a generic-proxy store that wgmma reads, so
//            fence.proxy.async and a block barrier stand between them. Tile
//            t + 1 is widened once S(t) and P(t-1) V(t-1) are done, so one
//            K and two V stages do (widening while they ran, with two K and
//            three V stages, was no faster and kept one block an SM);
//   scores   S = q k_int^T by wgmma (bf16 x bf16 -> f32, products exact),
//            then each key's column times its k-scale in f32 BEFORE
//            tile90::softmax applies sm_scale, the soft cap and the mask:
//            the reference's (q * scale) . (int8 * k_scale) up to f32
//            rounding;
//   P V      after the softmax (whose row sums use P itself), each key's
//            column of P times its v-scale, split into bf16 hi + lo, against
//            the integer V: P * v_scale rounded to bf16 alone would miss the
//            chip check, as P alone does in the bf16 kernel.
// Decode takes split-KV from the wrapper's _split_plan, merged by
// paged_attention_merge_kernel. Only pages below ceil(len / T) are read: the
// sink page and stale table entries never are.

#include "paged_attention_split.cuh"

namespace {

using paged::bf16;
using paged::Paged;
using tile90::kRows;
using tile90::kWarpgroup;

// What a block reads: its rows, its kv head and its split's keys (the
// frame of the bf16 kernel, paged_attention_multi.cu, written as helpers).
struct Block {
  int b, split, h, group, n_rows, row0;
  int key_begin, key_end, n_tiles;  // the split's keys, in tiles of BN
  const int32_t* table;             // the sequence's page-table row
  Paged p;

  // offset of row r of the tile in q (B, K, Hq, width), or -1 past the
  // rows
  __device__ __forceinline__ long long q_row(int r, int width) const {
    const int row = row0 + r;
    if (row >= n_rows) return -1;
    return ((static_cast<long long>(b) * p.n_q + row / group) * p.hq +
            h * group + row % group) * width;
  }
  // offset of key position pos of the block's kv head in the pages (P, T,
  // Hkv, width), or -1 past the split's keys
  __device__ __forceinline__ long long key_row(int pos, int width) const {
    if (pos >= key_end) return -1;
    const long long page = table[pos / p.page_tokens];
    return ((page * p.page_tokens + pos % p.page_tokens) * p.hkv + h) *
           width;
  }
};

// The block of this thread (rows of BM = 64 WG, tiles of BN keys), and each
// of the thread's two rows' key range in st.
template <int D, int BN, int WG>
__device__ __forceinline__ Block block(const Paged& p,
                                       const int32_t* __restrict__ page_table,
                                       const int32_t* __restrict__ lengths,
                                       tile90::Rows<D>& st) {
  constexpr int BM = kRows * WG;
  Block blk;
  blk.p = p;
  blk.b = blockIdx.z / p.n_splits;
  blk.split = blockIdx.z % p.n_splits;
  blk.h = blockIdx.y;
  blk.group = p.hq / p.hkv;
  blk.n_rows = p.n_q * blk.group;
  blk.row0 = blockIdx.x * BM;
  blk.table = page_table + size_t(blk.b) * p.table_width;
  const int T = p.page_tokens;
  const int len = lengths[blk.b];
  const int first_q = len - p.n_q;  // position of query 0

  st.init();
  const int wg_row0 = blk.row0 + (threadIdx.x / kWarpgroup) * kRows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wg_row0 + tile90::Rows<D>::row(i);
    const int qpos = first_q + r / blk.group;
    st.hi[i] = r < blk.n_rows ? qpos : -1;
    st.lo[i] = p.window > 0 ? qpos - p.window + 1 : 0;
  }

  // pages this block reads: up to the page of its newest query, never at or
  // past ceil(len / T) nor past the table's width (positions beyond its
  // columns are absent, as in the reference); with a window, none wholly
  // behind its oldest query's; then this split's range of them
  const int newest =
      first_q + (min(blk.row0 + BM, blk.n_rows) - 1) / blk.group;
  const int oldest = first_q + blk.row0 / blk.group;
  const int live = (len + T - 1) / T;
  const int page_end =
      newest < 0 ? 0 : min(min(live, newest / T + 1), p.table_width);
  int page_begin = 0;
  if (p.window > 0 && oldest - p.window + 1 > 0)
    page_begin = (oldest - p.window + 1) / T;
  const int sp0 = page_begin + blk.split * p.pages_per_split;
  const int sp1 = min(page_end, sp0 + p.pages_per_split);
  blk.key_begin = sp0 * T;
  blk.key_end = min(sp1 * T, newest + 1);
  blk.n_tiles = blk.key_end > blk.key_begin
                    ? (blk.key_end - blk.key_begin + BN - 1) / BN
                    : 0;
  // the zero-filled keys of the last tile past this split's range are not
  // the rows' to see (a later split's positions may lie below their hi)
#pragma unroll
  for (int i = 0; i < 2; ++i) st.hi[i] = min(st.hi[i], blk.key_end - 1);
  return blk;
}

// The thread's two rows of the block's result: normalised and cast to bf16
// into out (one pass), or the unnormalised f32 accumulator, max and sum
// into this split's row of the scratch (B, splits, K, Hq, .).
template <int D, bool kSplit>
__device__ __forceinline__ void store(const tile90::Rows<D>& st,
                                      const Block& blk, bf16* __restrict__ out,
                                      float* __restrict__ part_o,
                                      float* __restrict__ part_ml) {
  const int wg_row0 = blk.row0 + (threadIdx.x / kWarpgroup) * kRows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wg_row0 + tile90::Rows<D>::row(i);
    const float l = tile90::quad_sum(st.l[i]);
    if (r >= blk.n_rows) continue;
    const size_t orow = blk.q_row(r - blk.row0, 1);
    if constexpr (!kSplit) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      bf16* o = out + orow * D;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8)
        *reinterpret_cast<__nv_bfloat162*>(o + tile90::Rows<D>::col(n8, 0)) =
            __floats2bfloat162_rn(st.o[n8 * 4 + i * 2] * inv,
                                  st.o[n8 * 4 + i * 2 + 1] * inv);
    } else {
      const size_t per_seq = size_t(blk.p.n_q) * blk.p.hq;
      const size_t prow = (size_t(blk.b) * blk.p.n_splits + blk.split) *
                              per_seq + (orow - size_t(blk.b) * per_seq);
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

// bytes 2 half and 2 half + 1 of w (int8) as a bf16 pair, exact: each byte
// x in bits 0-7 and 16-23, then (128 + (x & 127)) - (128 + (x & 128)), both
// terms bf16 bit patterns (0x4300 is 128; with bit 7 set, 0x4380 is 256)
// whose difference x is an integer in [-128, 127], exact in bf16
__device__ __forceinline__ uint32_t i8_bf16(uint32_t w, int half) {
  const uint32_t a = __byte_perm(w, 0u, half ? 0x4342 : 0x4140);
  const uint32_t y = (a & 0x007F007Fu) | 0x43004300u;
  const uint32_t z = (a & 0x00800080u) | 0x43004300u;
  return tile90::bf16x2_bits(
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&y),
              *reinterpret_cast<const __nv_bfloat162*>(&z)));
}

// Dynamic shared memory of a block: its Q tile, one bf16 K and two bf16 V
// stages, two raw stages (int8 K rows, V rows, k-scales, v-scales), the
// widened tile's k- and v-scales, and 1 KB to align the base to the
// swizzle's 1024 bytes. At D = 128 a one-warpgroup block takes 100,864 B,
// so two blocks share an SM at decode.
template <int D, int BN, int WG>
struct Smem {
  static constexpr uint32_t kQ = kRows * WG * D * 2;
  static constexpr uint32_t kTile = BN * D * 2;          // bf16 K or V
  static constexpr uint32_t kRaw = 2 * BN * D + 2 * BN * 4;
  static constexpr size_t bytes =
      1024 + kQ + 3 * size_t(kTile) + 2 * size_t(kRaw) + 2 * BN * 4;
};

// The block's walk over the n_tiles tiles of BN keys of its split, each
// warpgroup folding every tile into its Rows. Step t starts S(t) = Q K(t)^T
// and O += P(t-1) V(t-1) together and runs the softmax of S(t) while the
// second product is on the tensor cores; then, every warpgroup past both,
// the block widens tile t + 1 into the one K stage and V stage (t + 1) % 2
// while the raw rows of tile t + 2 land.
template <int D, int BN, int WG>
__device__ __forceinline__ void attend_int8(
    tile90::Rows<D>& st, unsigned char* smem, const Block& blk,
    const bf16* q, const int8_t* k, const int8_t* v, const float* k_scale,
    const float* v_scale) {
  using namespace tile90;
  using S = Smem<D, BN, WG>;
  constexpr int BM = kRows * WG, THREADS = kWarpgroup * WG;
  constexpr int CH = D / 16;  // 16-byte int8 chunks of a row
  static_assert(BN * CH % THREADS == 0 && 2 * BN <= THREADS, "tile split");
  const int key_begin = blk.key_begin, n_tiles = blk.n_tiles;
  if (n_tiles <= 0) return;
  const uint32_t raw_base = smem_addr(smem);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  unsigned char* gsm = smem + (base - raw_base);  // the same, generic
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + S::kQ;         // the bf16 K stage
  const uint32_t v_s = k_s + S::kTile;      // bf16 V stages, tile t % 2
  const uint32_t r_s = v_s + 2 * S::kTile;  // raw stages, tile t % 2
  // the widened tile's k-scales, then its v-scales
  float* scl = reinterpret_cast<float*>(gsm + (r_s + 2 * S::kRaw - base));
  const int t4 = threadIdx.x % 4;

  // tile j's raw K and V rows and scales into raw stage j % 2
  auto fetch = [&](int j) {
    if (j >= n_tiles) return;
    const int key0 = key_begin + j * BN;
    const uint32_t dst = r_s + (j & 1) * S::kRaw;
#pragma unroll
    for (int i = 0; i < BN * CH / THREADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;  // row idx / CH, chunk % CH
      const long long off = blk.key_row(key0 + idx / CH, D);
      const long long e = off >= 0 ? off + (idx % CH) * 16 : 0;
      cp16(dst + idx * 16, k + e, off >= 0);
      cp16(dst + BN * D + idx * 16, v + e, off >= 0);
    }
    if (threadIdx.x < 2 * BN) {
      const long long off = blk.key_row(key0 + threadIdx.x % BN, 1);
      cp4(dst + 2 * BN * D + threadIdx.x * 4,
          (threadIdx.x < BN ? k_scale : v_scale) + (off >= 0 ? off : 0),
          off >= 0);
    }
  };
  // raw stage j % 2 -> the bf16 K stage, V stage j % 2 (integers, exact)
  // and the scales
  auto widen = [&](int j) {
    if (j >= n_tiles) return;
    const unsigned char* raw = gsm + (r_s + (j & 1) * S::kRaw - base);
#pragma unroll
    for (int i = 0; i < 2 * BN * CH / THREADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = (idx / CH) % BN, c = idx % CH;
      const uint4 w = *reinterpret_cast<const uint4*>(raw + idx * 16);
      unsigned char* dst =
          gsm + ((i < BN * CH / THREADS ? k_s : v_s + (j & 1) * S::kTile) -
                 base);
      const uint4 lo = make_uint4(i8_bf16(w.x, 0), i8_bf16(w.x, 1),
                                  i8_bf16(w.y, 0), i8_bf16(w.y, 1));
      const uint4 hi = make_uint4(i8_bf16(w.z, 0), i8_bf16(w.z, 1),
                                  i8_bf16(w.w, 0), i8_bf16(w.w, 1));
      // bf16 chunks 2c and 2c + 1; a quarter warp's eight stores land on
      // eight distinct bank groups when the threads of odd 64-column
      // halves (c & 4) store their second chunk first
      const bool swap = c & 4;
      *reinterpret_cast<uint4*>(dst + swz(BN, r, 2 * c + swap)) =
          swap ? hi : lo;
      *reinterpret_cast<uint4*>(dst + swz(BN, r, 2 * c + !swap)) =
          swap ? lo : hi;
    }
    if (threadIdx.x < 2 * BN)
      scl[threadIdx.x] =
          reinterpret_cast<const float*>(raw + 2 * BN * D)[threadIdx.x];
  };

  load_rows<BM, D, THREADS>(q_s, q,
                            [&](int r) { return blk.q_row(r, D); });
  fetch(0);
  cp_commit();  // with q
  fetch(1);
  cp_commit();
  cp_wait<1>();  // q and tile 0's raw rows landed
  __syncthreads();
  widen(0);
  const uint32_t q_wg = q_s + (threadIdx.x / kWarpgroup) * kRows * 128;
  float s[BN / 2];
  uint32_t ph[BN / 16][4], pl[BN / 16][4];
  for (int t = 0; t < n_tiles; ++t) {
    fence_async_smem();  // this thread's widened tile t (and q) to wgmma
    __syncthreads();     // every thread's; raw stage t % 2 is free
    fetch(t + 2);
    cp_commit();

#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    reg_fence(s);
    reg_fence(st.o);
    wg_fence();
    start_scores<D, BN>(s, q_wg, BM, k_s);
    wg_commit();
    if (t > 0) {
      start_pv<D, BN>(st, ph, pl, v_s + ((t - 1) & 1) * S::kTile);
      wg_commit();
      wg_wait<1>();  // the scores; P(t-1) V(t-1) may still run
    } else {
      wg_wait<0>();
    }
    reg_fence(s);
    // S of the integer keys to S of the keys: each column times its scale
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8) {
      const float2 c = *reinterpret_cast<const float2*>(scl + n8 * 8 + 2 * t4);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s[n8 * 4 + i * 2] *= c.x;
        s[n8 * 4 + i * 2 + 1] *= c.y;
      }
    }
    float corr[2], sum[2];
    softmax<D, BN>(st, s, key_begin + t * BN, blk.p.scale, blk.p.soft_cap,
                   corr, sum);
    wg_wait<0>();  // O and P(t-1) are free again
    reg_fence(st.o);
#pragma unroll
    for (int i = 0; i < 2; ++i) st.l[i] = st.l[i] * corr[i] + sum[i];
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        st.o[n8 * 4 + i * 2] *= corr[i];
        st.o[n8 * 4 + i * 2 + 1] *= corr[i];
      }
    // P meets the integer values: each column times its key's v-scale
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8) {
      const float2 c =
          *reinterpret_cast<const float2*>(scl + BN + n8 * 8 + 2 * t4);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s[n8 * 4 + i * 2] *= c.x;
        s[n8 * 4 + i * 2 + 1] *= c.y;
      }
    }
    split_p<BN>(s, ph, pl);
    cp_wait<1>();     // tile t + 1's raw rows landed (t + 2's may not)
    __syncthreads();  // every thread's; every warpgroup is past S(t),
                      // P(t-1) V(t-1) and tile t's scales
    widen(t + 1);
  }
  reg_fence(st.o);
  wg_fence();
  start_pv<D, BN>(st, ph, pl, v_s + ((n_tiles - 1) & 1) * S::kTile);
  wg_commit();
  wg_wait<0>();
  reg_fence(st.o);
}

template <int D, int BN, int WG, bool kSplit>
__global__ void __launch_bounds__(WG * kWarpgroup, 1)
paged_attention_multi_quant_kernel(const bf16* __restrict__ q,
                                   const int8_t* __restrict__ k_pages,
                                   const int8_t* __restrict__ v_pages,
                                   const float* __restrict__ k_scale,
                                   const float* __restrict__ v_scale,
                                   const int32_t* __restrict__ page_table,
                                   const int32_t* __restrict__ lengths,
                                   bf16* __restrict__ out,
                                   float* __restrict__ part_o,
                                   float* __restrict__ part_ml, Paged p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  tile90::Rows<D> st;
  const Block blk = block<D, BN, WG>(p, page_table, lengths, st);
  attend_int8<D, BN, WG>(st, smem, blk, q, k_pages, v_pages, k_scale,
                         v_scale);
  store<D, kSplit>(st, blk, out, part_o, part_ml);
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *pt, *lens;
  void *out, *part_o, *part_ml;
  int batch;
};

template <int D, int WG, bool kSplit>
struct Launch {
  static int run(const Args& a, const Paged& p, cudaStream_t stream) {
    constexpr int BN = D == 256 ? 32 : 64;
    return paged::launch<D, WG, kSplit>(
        paged_attention_multi_quant_kernel<D, BN, WG, kSplit>,
        Smem<D, BN, WG>::bytes, a.batch, p, a.out, a.part_o, a.part_ml,
        stream, static_cast<const bf16*>(a.q),
        static_cast<const int8_t*>(a.k), static_cast<const int8_t*>(a.v),
        static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
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
extern "C" int paged_attention_multi_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lengths, void* out, int batch, int n_q, int hq, int hkv,
    int head_dim, int page_tokens, int table_width, float scale,
    float soft_cap, int window, void* stream) {
  return paged::run<Launch, false>(
      Args{q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, out,
           nullptr, nullptr, batch},
      batch, head_dim, 1,
      Paged{n_q, hq, hkv, page_tokens, table_width, scale, soft_cap, window,
            1, table_width > 0 ? table_width : 1},
      stream);
}

// Split-KV: each sequence's pages in ranges of pages_per_split, n_splits
// blocks a (sequence, kv head, row tile), then the merge. part_o (B,
// n_splits, K, Hq, D) and part_ml (B, n_splits, K, Hq, 2) f32 are scratch
// the caller allocated.
extern "C" int paged_attention_multi_int8_split(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lengths, void* out, void* part_o, void* part_ml, int batch,
    int n_q, int hq, int hkv, int head_dim, int page_tokens,
    int table_width, float scale, float soft_cap, int window, int n_splits,
    int pages_per_split, void* stream) {
  return paged::run<Launch, true>(
      Args{q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, out,
           part_o, part_ml, batch},
      batch, head_dim, 1,
      Paged{n_q, hq, hkv, page_tokens, table_width, scale, soft_cap, window,
            n_splits, pages_per_split},
      stream);
}
