// Per-expert matmul against int4-packed weights for Hopper (sm_90a): X
// experts' products in one launch, bf16 activations in and out, f32 sums,
// with an optional device count of filled rows per expert.
//
// Replaces: k8s_runpod_kubelet_tpu/ops/int4_matmul.py:int4_expert_matmul
// (:181), the lax.map over experts of _matmul_2d -> pl.pallas_call (:64) ->
// _kernel (:83). Same function, per expert x:
//   y[x, r, o] = sum_g scale[x, g, o] * sum_i (h[x, r, 2i] * (lo - 8)
//                                              + h[x, r, 2i + 1] * (hi - 8))
//   over group g's packed rows i, where q4 (X, in/2, out) uint8 holds
//   in-element 2i in the low nibble (lo) and 2i + 1 in the high (hi), as
//   the quantizer wrote it (no repacked copy), and scale (X, g, 1, out) f32
//   has one group per in/g contraction elements. Each group's partial sum
//   is formed in f32 over exact products and then scaled into a running f32
//   sum, which is cast to bf16 once. Rows at or past counts[x] come back as
//   exact zeros.
//
// What bounds it on an H100: at decode and verify (a few filled rows an
// expert), the bytes of the experts that hold a row (Mixtral: 29.4 MB of q4
// and 1.8 MB of scales an expert and projection, 0.075 ms for the 7-8
// experts a decode step fills); at prefill the filled rows' operations (2 x
// 2048 x 4096 x 14336 at a 1024-token chunk, 0.24 ms at the bf16 tensor
// peak).
//
// Design. The product runs transposed, y^T = W^T h^T, as wgmma m64nNRk16:
// the weights are the A operand, taken from registers, h is the B operand
// (NR rows of the expert's buffer, K-major) in shared memory. One block an
// SM: a producer warpgroup and two consumer warpgroups.
//   walk       the persistent grid walks the live units (expert, column
//              tile, row tile): every block reads the counts itself and
//              skips the row tiles that start at or past its expert's count,
//              so no block slot is spent on a dead tile. Units are ordered
//              expert, then column tile, then row tile, so the row tiles
//              that share a column tile's weights run side by side and the
//              weights come from device memory about once. Which block runs
//              a unit depends on the counts; what a unit sums does not, so a
//              launch with counts and one at full capacity give the same
//              bytes in every filled row.
//   tile       from the buffer's rows C, which are static. Up to 64 rows
//              (decode C = 8, a K = 5 verify C = 40: one live tile an expert,
//              at the cost of decode) the tile is 16 rows x 128 columns and
//              its two consumer warpgroups split the groups in halves, each
//              walking its half in steps of 128 in-elements, and at the unit's
//              end the second hands its f32 sums to the first through shared
//              memory, which adds them (always first + second) and stores: a
//              unit is half as long, so the grid's units even out (Mixtral
//              gate/up at decode: 896 units on 132 blocks). Above, the tile is
//              64 rows x 256 columns, a warpgroup on each 128, in steps of 64
//              (two tiles' f32 sums and fragments fill the registers).
//   pipeline   one producer thread keeps TMA copies in flight into a ring of
//              stages (h through a 3-D tensor map that zero-fills past a
//              group's end, q4 through a 2-D map with the 128-byte swizzle,
//              the group's scales at its last step); each stage has a full
//              and an empty mbarrier. Consumer warpgroups wait on full,
//              unpack, run the step's wgmmas from registers and release the
//              stage on empty; no block barrier in the loop. One fragment
//              buffer: a warpgroup unpacks step t + 1 once its wgmmas of
//              step t are done, while the other warpgroup's wgmmas run
//              (a second buffer spills in the 224 registers a consumer
//              holds). setmaxnreg moves the producer warpgroup's registers
//              to the consumers (without it the tall tile spills in the
//              launch bounds' 168); its other three warps write the zeros
//              of every row past a count (plain stores that read no
//              weights).
//   unpack     a warpgroup owns 128 output columns as two m64 tiles, so a
//              thread holds four M rows, mapped to four adjacent columns:
//              one 32-bit shared read gives the four bytes of a packed row,
//              one byte each of the four A fragment registers (a register is
//              the (2i, 2i + 1) pair of one M row, exactly one byte's two
//              nibbles). Per word: a shift and three masks put the low
//              nibbles beside 0x43 bytes and the high nibbles in a word of
//              their own, one prmt a register lays out 0x43 | lo and 0x43 |
//              hi (bf16 128 + nibble, exact), one bf16x2 subtract of 136
//              makes (nibble - 8) exact: 13 instructions for four bytes with
//              the load (3.25 a byte; the row-13 tile takes 5). The columns
//              are placed so that, with the swizzle, a warp's 32 reads touch
//              32 banks.
//   scales     after a group's last step each thread folds its f32 partial
//              into its running sum with the group's four scales (one
//              16-byte read), then the stage is released.

#include <cuda.h>

#include "attention_tile_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tile90::kWarpgroup;

constexpr int kWN = 128;               // columns a consumer warpgroup owns
constexpr int kSmallRows = 64;         // buffers of at most this many rows
constexpr int kEncodeError = 10000;    // + CUresult of a failed map encode
constexpr int kRegisterError = 20000;  // + registers of an unexpected build

// A regime's block: NR rows a tile, CW consumer warpgroups side by side on
// the columns, KSPLIT of them on the groups (CW * KSPLIT = 2), KS
// in-elements a step.
template <int NR, int CW, int KSPLIT, int KS>
struct Tile {
  static constexpr int kConsumers = CW * KSPLIT;
  static constexpr int kThreads = (kConsumers + 1) * kWarpgroup;
  static constexpr int kCols = CW * kWN;               // a unit's columns
  static constexpr uint32_t kHBox = NR * 128;          // 64 in-elements of h
  static constexpr uint32_t kH = KS / 64 * kHBox;      // h bytes a step
  static constexpr uint32_t kQ = KS / 2 * kWN;         // q4 bytes a warpgroup
  static constexpr uint32_t kHalf = kH + CW * kQ;      // a group half's step
  static constexpr uint32_t kStage = KSPLIT * kHalf;   // multiple of 1024
  static constexpr uint32_t kScale = kCols * 4;        // a group's scales
  static constexpr int kStages = 196608 / kStage;
  // the second half's sums handed to the first at a unit's end
  static constexpr uint32_t kSwap = KSPLIT > 1 ? CW * NR * kWN * 4 : 0;
  // registers a thread at launch (the launch bounds' share of 64K), the
  // producer's after setmaxnreg, and the consumers' (what the producer
  // warpgroup gave up, spread over the consumer warpgroups)
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = 56;
  static constexpr int kConsumerRegs =
      kLaunchRegs + (kLaunchRegs - kProducerRegs) / kConsumers / 8 * 8;
  static constexpr size_t kSmem = 1024 +
                                  size_t(kStages) * (kStage + KSPLIT * kScale) +
                                  kSwap + (2 * kStages + 2 * CW) * 8;
};

struct Problem {
  const int* counts;  // (experts,) filled rows, or null for every row
  bf16* y;            // (experts, rows, out)
  int experts, rows, kin, out, groups;
  int gs;             // in-elements a group holds
  int chunks;         // steps a group takes
  int col_tiles;      // units of columns
};

// ------------------------------------------------------------- barriers --

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// -------------------------------------------------------------- copies --

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- walk --

// The live units of a launch, from the counts: expert x has ceil(live / NR)
// row tiles, each with every column tile. Unit u is (x, column tile c, row
// tile r), row tiles fastest; block b runs units b, b + gridDim.x, ...
template <int NR>
struct Walk {
  const Problem p;
  __device__ int live(int x) const {
    return p.counts == nullptr ? p.rows
                               : min(max(__ldg(p.counts + x), 0), p.rows);
  }
  // this block's units
  __device__ int mine() const {
    int n = 0;
    for (int x = 0; x < p.experts; ++x)
      n += (live(x) + NR - 1) / NR * p.col_tiles;
    return n > int(blockIdx.x) ? (n - 1 - int(blockIdx.x)) / int(gridDim.x) + 1
                               : 0;
  }
  // the block's i-th unit: expert, row tile, column tile, live rows
  __device__ void unit(int i, int& x, int& r, int& c, int& lv) const {
    int u = int(blockIdx.x) + i * int(gridDim.x);
    for (x = 0; x < p.experts; ++x) {
      lv = live(x);
      const int tiles = (lv + NR - 1) / NR;
      if (u < tiles * p.col_tiles) {
        c = u / tiles;
        r = u % tiles;
        return;
      }
      u -= tiles * p.col_tiles;
    }
  }
};

// Where a block is in its walk, step by step: the stage and its phase, the
// step's chunk of its group, the group within a half, the step within the
// unit and the block's unit (no division in the step loop).
struct Cursor {
  int st = 0, ph = 0, c = 0, gl = 0, ks = 0, unit = 0;
  __device__ __forceinline__ void next(int stages, int chunks, int spu) {
    if (++st == stages) {
      st = 0;
      ph ^= 1;
    }
    if (++ks == spu) {
      ks = c = gl = 0;
      ++unit;
    } else if (++c == chunks) {
      c = 0;
      ++gl;
    }
  }
};

// -------------------------------------------------------------- unpack --

// (w & MASK) | set in one lop3, set held in a register (written in C, the
// two constants take two instructions)
template <uint32_t MASK>
__device__ __forceinline__ uint32_t and_or(uint32_t w, uint32_t set) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(w), "n"(MASK),
      "r"(set));
  return d;
}

// The four bytes of word w (one packed row, output columns cb .. cb + 3) as
// the A fragment registers of their M rows: register j holds byte j's (low
// nibble - 8, high nibble - 8) as a bf16 pair, exact. 0x43 | n is bf16 128 +
// n; less 136 in one bf16x2 subtract. m_a = 0x43430000 and m_b =
// 0x00004343, in registers.
__device__ __forceinline__ void unpack4(uint32_t w, uint32_t m_a, uint32_t m_b,
                                        uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  const uint32_t hi = (w >> 4) & 0x0F0F0F0Fu;   // [hi3 hi2 hi1 hi0]
  const uint32_t a = and_or<0x00000F0Fu>(w, m_a);  // [43 43 lo1 lo0]
  const uint32_t b = and_or<0x0F0F0000u>(w, m_b);  // [lo3 lo2 43 43]
  const __nv_bfloat162 k = __floats2bfloat162_rn(136.f, 136.f);
  auto sub = [&](uint32_t v) {
    return tile90::bf16x2_bits(
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), k));
  };
  r0 = sub(__byte_perm(a, hi, 0x3430));  // [43 hi0 43 lo0]
  r1 = sub(__byte_perm(a, hi, 0x3531));  // [43 hi1 43 lo1]
  r2 = sub(__byte_perm(b, hi, 0x0602));  // [43 hi2 43 lo2]
  r3 = sub(__byte_perm(b, hi, 0x0703));  // [43 hi3 43 lo3]
}

// ------------------------------------------------------------- the kernel --

template <int NR, int CW, int KSPLIT, int KS>
__global__ void __launch_bounds__(Tile<NR, CW, KSPLIT, KS>::kThreads, 1)
int4_expert_matmul_kernel(const __grid_constant__ CUtensorMap h_map,
                          const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap s_map,
                          const Problem p) {
  using T = Tile<NR, CW, KSPLIT, KS>;
  constexpr int S = T::kStages;
  constexpr int KK = KS / 16;                    // k16 slices a step
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = tile90::smem_addr(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem + (base - raw);
  const uint32_t scales = base + S * T::kStage;  // S x KSPLIT slots
  const uint32_t swap = scales + S * KSPLIT * T::kScale;
  const uint32_t full = swap + T::kSwap;         // S mbarriers
  const uint32_t empty = full + S * 8;           // S mbarriers
  const uint32_t swap_full = empty + S * 8;      // CW mbarriers
  const uint32_t swap_empty = swap_full + CW * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, T::kConsumers * 4);  // a warp's arrival each
    }
    for (int i = 0; i < CW; ++i) {
      mbar_init(swap_full + 8 * i, 4);
      mbar_init(swap_empty + 8 * i, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Walk<NR> walk{p};
  const int gh = (p.groups + KSPLIT - 1) / KSPLIT;  // groups a half walks
  const int spu = gh * p.chunks;                    // steps a unit
  const int steps = walk.mine() * spu;

  if (threadIdx.x < kWarpgroup) {
    setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x == 0) {
      // the producer: each half's h, q4 and (at a group's last step)
      // scales of the step
      Cursor k;
      int x = 0, r = 0, c = 0, lv = 0;
      for (int t = 0; t < steps; ++t, k.next(S, p.chunks, spu)) {
        mbar_wait(empty + 8 * k.st, k.ph ^ 1);
        if (k.ks == 0) walk.unit(k.unit, x, r, c, lv);
        const bool last = k.c == p.chunks - 1;
        const int k0 = k.c * KS;
        const uint32_t bar = full + 8 * k.st;
        int halves = 0;
        for (int j = 0; j < KSPLIT; ++j) halves += j * gh + k.gl < p.groups;
        mbar_expect_tx(bar, halves * (T::kHalf + (last ? T::kScale : 0)));
        for (int j = 0; j < KSPLIT; ++j) {
          const int g = j * gh + k.gl;
          if (g >= p.groups) continue;
          const uint32_t dst = base + k.st * T::kStage + j * T::kHalf;
#pragma unroll
          for (int b = 0; b < KS / 64; ++b)
            tma_3d(dst + b * T::kHBox, &h_map, bar, k0 + 64 * b, g,
                   x * p.rows + r * NR);
#pragma unroll
          for (int i = 0; i < CW; ++i)
            tma_2d(dst + T::kH + i * T::kQ, &q_map, bar,
                   c * T::kCols + i * kWN,
                   x * (p.kin / 2) + g * (p.gs / 2) + k0 / 2);
          if (last)
            tma_2d(scales + (k.st * KSPLIT + j) * T::kScale, &s_map, bar,
                   c * T::kCols, x * p.groups + g);
        }
      }
      return;
    }
    if (threadIdx.x < 32) return;
    // the other three warps: zeros in every row past a count
    const int z = threadIdx.x - 32, n8 = p.out / 8;
    int dead = 0;
    for (int x = 0; x < p.experts; ++x) dead += p.rows - walk.live(x);
    for (int d = blockIdx.x; d < dead; d += gridDim.x) {
      int x = 0, row = d;
      for (;; ++x) {
        const int lv = walk.live(x);
        if (row < p.rows - lv) {
          row += lv;
          break;
        }
        row -= p.rows - lv;
      }
      uint4* out = reinterpret_cast<uint4*>(
          p.y + (size_t(x) * p.rows + row) * p.out);
      for (int i = z; i < n8; i += 3 * 32) out[i] = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  setmaxnreg_inc<T::kConsumerRegs>();
  using namespace tile90;
  const int ci = threadIdx.x / kWarpgroup - 1;
  const int wi = ci % CW, half = ci / CW;  // columns, and the groups' half
  const int tw = threadIdx.x % kWarpgroup;
  const int w = tw / 32, lane = tw % 32, g8 = lane / 4, t4 = lane % 4;
  // this thread's four columns cb .. cb + 3 (of the warpgroup's 128): M rows
  // g8 and g8 + 8 of warp w in tile 0, then the same in tile 1. Word q of a
  // 128-byte row sits in 16-byte chunk 4 (g8 / 4) + w, so a warp's reads of
  // four rows (t4) spread over all 32 banks under the swizzle.
  const int chunk = 4 * (g8 >> 2) + w;
  const int cb = 4 * (4 * chunk + (g8 & 3));
  // byte offsets, inside this warpgroup's swizzled q4 tile, of the two rows
  // of k16 slice 0 this thread reads (slice kk is 1024 bytes on; the
  // swizzle's row index is 4 h + t4 for every slice)
  const uint32_t qoff[2] = {
      uint32_t((0 + t4) * 128 + ((chunk ^ (0 + t4)) << 4) + (g8 & 3) * 4),
      uint32_t((4 + t4) * 128 + ((chunk ^ (4 + t4)) << 4) + (g8 & 3) * 4)};
  // the unpack's byte masks, kept in registers across the loop
  uint32_t m_a = 0x43430000u, m_b = 0x00004343u;
  asm volatile("" : "+r"(m_a), "+r"(m_b));
  const uint32_t mine_h = base + half * T::kHalf;
  const unsigned char* mine_q = gbase + half * T::kHalf + T::kH + wi * T::kQ;
  const unsigned char* mine_s =
      gbase + (scales - base) + half * T::kScale + (wi * kWN + cb) * 4;
  // whether this warpgroup's half has a group at the cursor's step (the
  // second half runs short when the groups are odd; its idle steps compute
  // on stale stages and are never folded)
  auto active = [&](const Cursor& k) {
    return half * gh + k.gl < p.groups;
  };

  float acc[2][NR / 2], part[2][NR / 2];
#pragma unroll
  for (int i = 0; i < NR / 2; ++i)
    acc[0][i] = acc[1][i] = part[0][i] = part[1][i] = 0.f;
  uint32_t f[2][KK][4];  // [tile][k16 slice][register]

  auto unpack = [&](const Cursor& k) {
    const unsigned char* q = mine_q + k.st * T::kStage;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t word =
            *reinterpret_cast<const uint32_t*>(q + kk * 1024 + qoff[h]);
        unpack4(word, m_a, m_b, f[0][kk][h * 2], f[0][kk][h * 2 + 1],
                f[1][kk][h * 2], f[1][kk][h * 2 + 1]);
      }
  };
  // the step's wgmmas into part (the first of a group overwrites it)
  auto issue = [&](const Cursor& k) {
    const uint32_t hs = mine_h + k.st * T::kStage;
    reg_fence(part[0]);
    reg_fence(part[1]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint64_t d = desc(hs + (kk / 4) * T::kHBox + (kk % 4) * 32, 16,
                              1024);
      MmaRS<NR, 0>::run(part[0], f[0][kk], d, k.c > 0 || kk > 0);
      MmaRS<NR, 0>::run(part[1], f[1][kk], d, k.c > 0 || kk > 0);
    }
    wg_commit();
  };
  // the unit's sums, complete: (with the groups split) the second half
  // hands its sums to the first, which adds them; the filled rows stored
  auto end_unit = [&](int unit) {
    if constexpr (KSPLIT > 1) {
      float* sw = reinterpret_cast<float*>(gbase + (swap - base)) +
                  wi * NR * kWN + tw;
      if (half == 1) {
        mbar_wait(swap_empty + 8 * wi, (unit & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < NR / 2; ++i) {
          sw[i * kWN] = acc[0][i];
          sw[(NR / 2 + i) * kWN] = acc[1][i];
          acc[0][i] = acc[1][i] = 0.f;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(swap_full + 8 * wi);
        return;
      }
      mbar_wait(swap_full + 8 * wi, unit & 1);
#pragma unroll
      for (int i = 0; i < NR / 2; ++i) {
        acc[0][i] += sw[i * kWN];
        acc[1][i] += sw[(NR / 2 + i) * kWN];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(swap_empty + 8 * wi);
    }
    int x, r, c, lv;
    walk.unit(unit, x, r, c, lv);
    const int col = c * T::kCols + wi * kWN + cb;
#pragma unroll
    for (int n8 = 0; n8 < NR / 8; ++n8)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = r * NR + n8 * 8 + 2 * t4 + j;
        if (row < lv && col < p.out) {
          const __nv_bfloat162 v0 = __floats2bfloat162_rn(
              acc[0][n8 * 4 + j], acc[0][n8 * 4 + 2 + j]);
          const __nv_bfloat162 v1 = __floats2bfloat162_rn(
              acc[1][n8 * 4 + j], acc[1][n8 * 4 + 2 + j]);
          *reinterpret_cast<uint2*>(p.y + (size_t(x) * p.rows + row) * p.out +
                                    col) =
              make_uint2(bf16x2_bits(v0), bf16x2_bits(v1));
        }
      }
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) acc[0][i] = acc[1][i] = 0.f;
  };
  // the step's products are in part: at a group's end fold them into acc
  // with the group's scales, release the stage, end the unit at its last
  // step
  auto finish = [&](const Cursor& k) {
    if (k.c == p.chunks - 1 && active(k)) {
      const float4 sc = *reinterpret_cast<const float4*>(
          mine_s + k.st * KSPLIT * T::kScale);
#pragma unroll
      for (int n8 = 0; n8 < NR / 8; ++n8)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc[0][n8 * 4 + j] = fmaf(part[0][n8 * 4 + j], sc.x,
                                    acc[0][n8 * 4 + j]);
          acc[0][n8 * 4 + 2 + j] = fmaf(part[0][n8 * 4 + 2 + j], sc.y,
                                        acc[0][n8 * 4 + 2 + j]);
          acc[1][n8 * 4 + j] = fmaf(part[1][n8 * 4 + j], sc.z,
                                    acc[1][n8 * 4 + j]);
          acc[1][n8 * 4 + 2 + j] = fmaf(part[1][n8 * 4 + 2 + j], sc.w,
                                        acc[1][n8 * 4 + 2 + j]);
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * k.st);
    if (k.ks == spu - 1) end_unit(k.unit);
  };

  if (steps == 0) return;
  // one fragment buffer: a warpgroup unpacks a step once its wgmmas of the
  // step before are done, while the other warpgroup's run (a second
  // buffer spills: ptxas allocates consumer code within the launch bounds'
  // 168 registers)
  Cursor cur, prev;
  mbar_wait(full + 8 * cur.st, cur.ph);
  unpack(cur);
  issue(cur);
  prev = cur;
  cur.next(S, p.chunks, spu);
  for (int n = 1; n < steps; ++n) {
    mbar_wait(full + 8 * cur.st, cur.ph);
    wg_wait<0>();
    reg_fence(part[0]);
    reg_fence(part[1]);
    finish(prev);
    unpack(cur);
    issue(cur);
    prev = cur;
    cur.next(S, p.chunks, spu);
  }
  wg_wait<0>();
  reg_fence(part[0]);
  reg_fence(part[1]);
  finish(prev);
}

// --------------------------------------------------------------- launch --

int encode(CUtensorMap* map, CUtensorMapDataType type, int rank,
           const void* ptr, const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, type, rank, const_cast<void*>(ptr), dims, strides, box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + int(r);
}

template <int NR, int CW, int KSPLIT, int KS>
int launch(const void* h, const void* q4, const void* scale, const int* counts,
           void* y, int experts, int rows, int kin, int out, int groups,
           cudaStream_t stream) {
  using T = Tile<NR, CW, KSPLIT, KS>;
  auto kernel = int4_expert_matmul_kernel<NR, CW, KSPLIT, KS>;
  // setmaxnreg hands the producer's registers to the consumers: the build
  // must hold exactly the launch bounds' share, or the consumers would wait
  // on registers that were never freed
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs != T::kLaunchRegs) return kRegisterError + attr.numRegs;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(T::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);

  const int gs = kin / groups;
  CUtensorMap hm, qm, sm;
  // h (experts * rows, groups, gs) bf16: a box is 64 in-elements of one
  // group for NR rows, zeros past the group's end and past the last row
  const cuuint64_t h_dims[3] = {cuuint64_t(gs), cuuint64_t(groups),
                                cuuint64_t(experts) * rows};
  const cuuint64_t h_strides[2] = {cuuint64_t(gs) * 2, cuuint64_t(kin) * 2};
  const cuuint32_t h_box[3] = {64, 1, NR};
  // q4 (experts * kin / 2, out) uint8: KS / 2 packed rows of 128 columns
  const cuuint64_t q_dims[2] = {cuuint64_t(out),
                                cuuint64_t(experts) * (kin / 2)};
  const cuuint64_t q_strides[1] = {cuuint64_t(out)};
  const cuuint32_t q_box[2] = {kWN, KS / 2};
  // scale (experts * groups, out) f32: one group's scales of a unit
  const cuuint64_t s_dims[2] = {cuuint64_t(out),
                                cuuint64_t(experts) * groups};
  const cuuint64_t s_strides[1] = {cuuint64_t(out) * 4};
  const cuuint32_t s_box[2] = {T::kCols, 1};
  int code;
  if ((code = encode(&hm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, h, h_dims,
                     h_strides, h_box, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (code = encode(&qm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q4, q_dims,
                     q_strides, q_box, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (code = encode(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scale, s_dims,
                     s_strides, s_box, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return code;

  Problem p;
  p.counts = counts;
  p.y = static_cast<bf16*>(y);
  p.experts = experts;
  p.rows = rows;
  p.kin = kin;
  p.out = out;
  p.groups = groups;
  p.gs = gs;
  p.chunks = (gs + KS - 1) / KS;
  p.col_tiles = (out + T::kCols - 1) / T::kCols;
  kernel<<<sms, T::kThreads, T::kSmem, stream>>>(hm, qm, sm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tile height a buffer of `rows` rows an expert takes.
extern "C" int int4_expert_matmul_tile_rows(int rows) {
  return rows <= kSmallRows ? 16 : 64;
}

// C entry point bound by ops/int4_matmul.py through ctypes: h (experts, rows,
// kin) bf16, q4 (experts, kin/2, out) uint8, scale (experts, groups, 1, out)
// f32, y (experts, rows, out) bf16, each 16-byte aligned; counts a device
// int32 (experts,) of each expert's filled rows, or null for all rows. Rows
// at or past an expert's count come back as zeros. One launch, no scratch.
// Returns 0, a cudaError_t code (cudaErrorInvalidValue for shapes the kernel
// does not take: a group that is not a multiple of 16 in-elements, out not a
// multiple of 16; the Python wrapper rejects those first), 10000 + a
// CUresult if a tensor map does not encode, or 20000 + the registers of a
// build whose count is not the launch bounds'.
extern "C" int int4_expert_matmul_bf16(const void* h, const void* q4,
                                       const void* scale, const void* counts,
                                       void* y, int experts, int rows,
                                       int kin, int out, int groups,
                                       void* stream) {
  if (experts < 0) return int(cudaErrorInvalidValue);
  if (experts == 0 || rows == 0 || out == 0) return 0;
  if (kin <= 0 || groups <= 0 || kin % groups || (kin / groups) % 16 ||
      out % 16)
    return int(cudaErrorInvalidValue);
  const int* c = static_cast<const int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rows <= kSmallRows
             ? launch<16, 1, 2, 128>(h, q4, scale, c, y, experts, rows, kin,
                                     out, groups, s)
             : launch<64, 2, 1, 64>(h, q4, scale, c, y, experts, rows, kin,
                                    out, groups, s);
}
