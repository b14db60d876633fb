// Fine-grained-scaled FP8 GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fp8_gemm/fp8_gemm.py:fp8_gemm
// (pallas_call at :59).
//   y (M,N) fp32 = (xq * xs) @ (wq * ws)
//   xq (M,K) E4M3 bytes, row-major; xs (M, K/128) fp32   -- 1x128 tiles
//   wq (K,N) E4M3 bytes stored K-contiguous: an (N, K) row-major buffer
//      (rows `ldw` bytes apart), made once at load; ws (K/128, ceil(N/128))
//      fp32 -- 128x128 weight blocks
// K % 128 == 0; M and N are any size (TMA fills rows past the end with
// zeros; stores are masked).
//
// Numerics (both kernels): E4M3 codes are converted exactly to fp16 in
// registers (every E4M3 value is an fp16 value; cvt.rn.f16x2.e4m3x2), the
// products of one 128-deep K group go into a fresh fp32 partial on the
// tensor cores (fp16 x fp16 products are exact in fp32), and the partial is
// promoted: acc += partial * (xs[m,k] * ws[k,n]), the paper's §3.1
// per-group promotion at N_C = 128. The FP8 tensor-core path is not used:
// its accumulation keeps about 13 fraction bits (paper §3.1.1).
//
// K order inside each group: a thread's fragment registers for the four
// k16 steps of a 64-deep half hold K = 16t + 4j + [0, 4) (t = lane % 4, j
// the step), so one 16-byte read of a row feeds four steps; both operands
// use the same permutation, which a sum does not see. Rows of a warp's
// fragments are taken in the order rho(g) = 4(g & 1) + g / 2, so the two
// rows a quarter-warp reads sit in opposite halves of the 128-byte TMA
// swizzle: every shared-memory read is free of bank conflicts.
//
// Two regimes, chosen by the wrapper's launch plan (kernels/fp8_gemm/
// ops.py, from M, N, K and the SM count alone):
//
// * decode (M <= 64): bound by the weight bytes (1 per weight; at M = 4
//   the FFN's 132 MB take 0.0395 ms at 3.35 TB/s). fp8_gemm_decode_kernel
//   streams (128-row N tile, 128-deep K group) units of the weight, 16 KB
//   each, split over every SM: CTA c takes units [c * per, (c+1) * per) of
//   the N-tile-major list (stream-K), so every CTA reads the same bytes.
//   A producer warp keeps a ring of up to 8 stages in flight by TMA (the
//   weight box and the group's x rows). Eight consumer warps run
//   mma.sync.m16n8k16 with the weight as the 16-row A operand and up to 8
//   n8 tiles of x rows as B, promote each unit's partial, and write one
//   fp32 partial per (N tile, CTA) segment to a workspace.
//   fp8_gemm_reduce_kernel then sums each tile's segments in a fixed order
//   into y: no float atomics, so the output is the same bits every run.
// * prefill (M > 64): bound by the tensor cores (M = 1024 x 7168 x 18432 is
//   2.7e11 operations: 0.137 ms at the fp8 rate, 0.274 at fp16's).
//   fp8_gemm_prefill_kernel: persistent CTAs (one per SM) walk 128 x 128
//   output tiles in groups of 8 M tiles (the CTAs in flight share their
//   weight tiles in L2); where the tiles fill under half the SMs (the
//   narrow w_dkv, w_kr), each tile's K is split too, and the reduce kernel
//   sums the splits in order. A producer warpgroup (setmaxnreg.dec)
//   TMA-loads each group's x tile and weight tile (128 rows x 128 B each)
//   into a 4-stage mbarrier ring, and one of its warps copies the group's
//   scales into the stage (no consumer waits on a global load: the fence
//   before wgmma reads the converted tile waits for every load in flight). Two consumer warpgroups (setmaxnreg.inc) own 64
//   rows of x each: x is wgmma's A operand, converted in registers; the
//   weight tile is converted cooperatively into a 128-byte-swizzled fp16
//   B tile (double-buffered), read by wgmma m64n128k16 from shared memory.
//   The conversion of group k+1 runs under group k's wgmma; one named
//   barrier per group orders both. The weight, not x, is the shared-memory
//   operand: at 128 x 128 the two conversions cost the same, and with x in
//   registers each thread's outputs are whole rows of y (two x scales a
//   thread, contiguous stores).
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <list>
#include <mutex>
#include <unordered_map>
#include <utility>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace hopper;

constexpr int BLOCK = 128;     // the scale group (K) and weight block (N)
constexpr int ROWB = 128;      // bytes of one row's K group

// Two E4M3 codes (the low 16 bits, lower index first) -> f16x2, exact.
__device__ __forceinline__ uint32_t cvt2(uint32_t v) {
  uint32_t h2;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n"
      : "=r"(h2) : "h"(static_cast<uint16_t>(v)));
  return h2;
}

// The fragment row order of a warp's 8-row group (see the head comment).
__device__ __forceinline__ int rho(int g) { return ((g & 1) << 2) | (g >> 1); }

// A 16-byte chunk of a 128-byte-swizzled tile: logical chunk c of row r.
__device__ __forceinline__ uint4 chunk(const uint8_t* tile, int r, int c) {
  return *reinterpret_cast<const uint4*>(tile + r * ROWB + ((c ^ (r & 7)) << 4));
}

// The four k16-step fragments of one 64-deep half from two rows' chunks
// (lo: row g, hi: row g + 8): step j takes K 16t + 4j + [0, 4).
__device__ __forceinline__ void frags(const uint4& lo, const uint4& hi,
                                      uint32_t (&a)[4][4]) {
  const uint32_t l[4] = {lo.x, lo.y, lo.z, lo.w};
  const uint32_t u[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = cvt2(l[j]);
    a[j][1] = cvt2(u[j]);
    a[j][2] = cvt2(l[j] >> 16);
    a[j][3] = cvt2(u[j] >> 16);
  }
}

// ---------------------------------------------------------------------------
// decode: stream-K over the weight, mma.sync, a fixed-order reduce
// ---------------------------------------------------------------------------

constexpr int DEC_WARPS = 8;                         // 16 weight rows each
constexpr int DEC_THREADS = (DEC_WARPS + 1) * 32;    // + a producer warp

// A stage: the weight box (128 N rows x 128 B), then the x box (8 * NT8
// rows x 128 B; rows past M arrive as zeros), on 1024-byte boundaries (the
// swizzle's period). Two CTAs share an SM up to 24 x rows (at two CTAs a
// thread has 96 registers; 32 rows would spill).
template <int NT8>
struct Dec {
  static constexpr int CTAS = NT8 <= 3 ? 2 : 1;
  static constexpr int BUDGET = CTAS == 2 ? 113664 : 227328;
  static constexpr int XR = 8 * NT8;
  static constexpr int W_BYTES = BLOCK * ROWB;
  static constexpr int TX = W_BYTES + XR * ROWB;
  static constexpr int BYTES = (TX + 1023) / 1024 * 1024;
  static constexpr int COUNT =
      (BUDGET - 1024) / (BYTES + 16) > 8 ? 8 : (BUDGET - 1024) / (BYTES + 16);
  static constexpr int SMEM = 1024 + COUNT * BYTES + 16 * COUNT;
  static_assert(COUNT >= 2, "the ring needs two stages");
};

template <int NT8>
__global__ void __launch_bounds__(DEC_THREADS, (Dec<NT8>::CTAS))
fp8_gemm_decode_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w,
                       const float* __restrict__ xs,
                       const float* __restrict__ ws,
                       float* __restrict__ part, int M, int N, int K,
                       int per, int maxc) {
  using S = Dec<NT8>;
  extern __shared__ uint8_t smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KB = K / BLOCK, NB = (N + BLOCK - 1) / BLOCK;
  const int u0 = blockIdx.x * per;
  const int count = min(per, NB * KB - u0);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full = base + S::COUNT * S::BYTES;
  const uint32_t empty = full + 8 * S::COUNT;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::COUNT; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, DEC_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (count <= 0) return;

  if (warp == DEC_WARPS) {
    // producer: one lane keeps the ring up to COUNT units ahead
    if (lane != 0) return;
    for (int s = 0; s < count; ++s) {
      const int slot = s % S::COUNT, round = s / S::COUNT;
      if (round > 0) mbar_wait(empty + 8 * slot, (round - 1) & 1);
      const int u = u0 + s, nt = u / KB, kb = u % KB;
      const uint32_t st = base + slot * S::BYTES, bar = full + 8 * slot;
      mbar_arrive_tx(bar, S::TX);
      tma_load_2d(st, &tm_w, bar, kb * ROWB, nt * BLOCK);
      tma_load_2d(st + S::W_BYTES, &tm_x, bar, kb * ROWB, 0);
    }
    return;
  }

  // consumers: warp w owns weight rows 16w + rho(g) and + 8 of each unit;
  // column g of n8 tile n is x row 8n + rho(g), so the accumulator's
  // columns 2t and 2t + 1 are x rows 8n + t and 8n + 4 + t
  const int g = lane >> 2, t = lane & 3;
  const int rg = rho(g);
  const int r0 = warp * 16 + rg;
  float acc[NT8][4];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;

  for (int s = 0; s < count; ++s) {
    const int u = u0 + s, nt = u / KB, kb = u % KB;
    // the unit's scales, read before its stage is waited for (their
    // latency hides under the wait and the products): xs of this thread's
    // two x rows per n8 tile (0 past M), ws of the unit's block
    float sx[NT8][2];
    const float sw = ws[kb * NB + nt];
#pragma unroll
    for (int n = 0; n < NT8; ++n) {
      const int m0 = 8 * n + t, m1 = m0 + 4;
      sx[n][0] = m0 < M ? xs[m0 * KB + kb] : 0.f;
      sx[n][1] = m1 < M ? xs[m1 * KB + kb] : 0.f;
    }
    const int slot = s % S::COUNT;
    mbar_wait(full + 8 * slot, (s / S::COUNT) & 1);
    const uint8_t* wt = smem + slot * S::BYTES;
    const uint8_t* xt = wt + S::W_BYTES;

    float p[NT8][4];
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[n][r] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 4 * h + t;
      uint32_t a[4][4];
      frags(chunk(wt, r0, c), chunk(wt, r0 + 8, c), a);
#pragma unroll
      for (int n = 0; n < NT8; ++n) {
        const uint4 v = chunk(xt, 8 * n + rg, c);
        const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b[2] = {cvt2(vv[j]), cvt2(vv[j] >> 16)};
          mma_f16_16816(p[n], a[j], b);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);     // the stage is read

#pragma unroll
    for (int n = 0; n < NT8; ++n) {
      const float s0 = sx[n][0] * sw, s1 = sx[n][1] * sw;
      acc[n][0] = fmaf(p[n][0], s0, acc[n][0]);
      acc[n][1] = fmaf(p[n][1], s1, acc[n][1]);
      acc[n][2] = fmaf(p[n][2], s0, acc[n][2]);
      acc[n][3] = fmaf(p[n][3], s1, acc[n][3]);
    }
    if (kb == KB - 1 || s == count - 1) {
      // the segment of tile nt ends: its partial goes to slot j of the
      // tile, j = this CTA's rank among the tile's CTAs
      const int j = blockIdx.x - nt * KB / per;
      float* pt = part + (static_cast<size_t>(nt) * maxc + j) * M * BLOCK;
#pragma unroll
      for (int n = 0; n < NT8; ++n) {
        const int m0 = 8 * n + t, m1 = m0 + 4;
        if (m0 < M) {
          pt[m0 * BLOCK + r0] = acc[n][0];
          pt[m0 * BLOCK + r0 + 8] = acc[n][2];
        }
        if (m1 < M) {
          pt[m1 * BLOCK + r0] = acc[n][1];
          pt[m1 * BLOCK + r0 + 8] = acc[n][3];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
      }
    }
  }
}

// y[m, n] = the sum of tile n / 128's segments, in segment order: the
// stream-K segments of the decode plan (per > 0), or `maxc` K splits of the
// prefill plan (per == 0).
__global__ void __launch_bounds__(256)
fp8_gemm_reduce_kernel(const float* __restrict__ part, float* __restrict__ y,
                       int M, int N, int KB, int per, int maxc) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long>(M) * N) return;
  const int m = static_cast<int>(i / N), n = static_cast<int>(i % N);
  const int nt = n / BLOCK;
  const int segs =
      per ? ((nt + 1) * KB - 1) / per - nt * KB / per + 1 : maxc;
  const float* p = part + (static_cast<size_t>(nt) * maxc * M + m) * BLOCK
                   + n % BLOCK;
  float sum = p[0];
  for (int j = 1; j < segs; ++j) sum += p[static_cast<size_t>(j) * M * BLOCK];
  y[i] = sum;
}

// ---------------------------------------------------------------------------
// prefill: persistent, warp-specialised, wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int PF_STAGES = 4;
constexpr int PF_THREADS = 384;        // consumer WG 0, 1; producer WG 2
constexpr int PF_GROUP_M = 8;          // M tiles per group of the tile order
constexpr int PRODUCER_REGS = 24;      // 24 * 128 + 240 * 256 <= 65536
constexpr int CONSUMER_REGS = 240;

// Offsets from a 1024-byte aligned base: the raw ring (per stage the x box
// and the weight box, 128 rows x 128 B each, then the group's scales: xs of
// the tile's 128 rows and ws), two fp16 B tiles (each two 64-deep halves of
// 128 rows x 128 B, 128-byte swizzled), the mbarriers.
struct Pf {
  static constexpr int X_BYTES = BLOCK * ROWB;
  static constexpr int SC_OFF = 2 * X_BYTES;
  static constexpr int TX = 2 * X_BYTES;           // bytes by TMA a stage
  static constexpr int STAGE = SC_OFF + 1024;
  static constexpr int B_OFF = PF_STAGES * STAGE;
  static constexpr int B_HALF = BLOCK * 128;
  static constexpr int B_BYTES = 2 * B_HALF;
  static constexpr int BAR_OFF = B_OFF + 2 * B_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 16 * PF_STAGES;
};

// Tile i of the order: groups of PF_GROUP_M M tiles, M fastest within a
// group, so the CTAs in flight read few weight tiles, each from HBM once.
__device__ __forceinline__ void pf_tile(int i, int MB, int NB, int& mt,
                                        int& nt) {
  const int per_group = PF_GROUP_M * NB;
  const int first = (i / per_group) * PF_GROUP_M;
  const int rows = min(MB - first, PF_GROUP_M);
  const int r = i % per_group;
  mt = first + r % rows;
  nt = r / rows;
}

// Work item i: tile i / splits of the order, K groups [j KB / splits,
// (j + 1) KB / splits) with j = i % splits. With one split a tile's output
// goes to y; with more, each item's partial goes to slot j of its N tile's
// (splits, M, 128) slab of `part`, which fp8_gemm_reduce_kernel sums.
__global__ void __launch_bounds__(PF_THREADS, 1)
fp8_gemm_prefill_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w,
                        const float* __restrict__ xs,
                        const float* __restrict__ ws, float* __restrict__ y,
                        float* __restrict__ part, int M, int N, int K,
                        int splits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full = base + Pf::BAR_OFF;
  const uint32_t empty = full + 8 * PF_STAGES;
  const int tid = threadIdx.x;
  const int KB = K / BLOCK, NB = (N + BLOCK - 1) / BLOCK;
  const int MB = (M + BLOCK - 1) / BLOCK;
  const int items = MB * NB * splits;

  if (tid == 0) {
    for (int i = 0; i < PF_STAGES; ++i) {
      mbar_init(full + 8 * i, 33);      // the TMA thread, the scale warp
      mbar_init(empty + 8 * i, 8);      // one per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup: one thread issues the TMA loads; one warp
    // copies each group's scales into the stage, so the consumers never
    // wait on a global load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pw = (tid - 256) >> 5, lane = tid & 31;
    if (pw > 1 || (pw == 0 && lane != 0)) return;
    int s = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      int mt, nt;
      pf_tile(i / splits, MB, NB, mt, nt);
      const int j = i % splits;
      for (int kb = j * KB / splits; kb < (j + 1) * KB / splits; ++kb, ++s) {
        const int slot = s % PF_STAGES, round = s / PF_STAGES;
        if (round > 0) mbar_wait(empty + 8 * slot, (round - 1) & 1);
        const uint32_t st = base + slot * Pf::STAGE, bar = full + 8 * slot;
        if (pw == 0) {
          mbar_arrive_tx(bar, Pf::TX);
          tma_load_2d(st, &tm_x, bar, kb * ROWB, mt * BLOCK);
          tma_load_2d(st + Pf::X_BYTES, &tm_w, bar, kb * ROWB, nt * BLOCK);
        } else {
          float* sc = reinterpret_cast<float*>(smem + slot * Pf::STAGE +
                                               Pf::SC_OFF);
          for (int r = lane; r < BLOCK; r += 32) {
            const int row = mt * BLOCK + r;
            sc[r] = row < M ? xs[static_cast<size_t>(row) * KB + kb] : 0.f;
          }
          if (lane == 0) sc[BLOCK] = ws[kb * NB + nt];
          mbar_arrive(bar);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's A rows (and output rows): ra and ra + 8 of the tile
  const int ra = wg * 64 + warp * 16 + rho(g);
  // the row and 64-deep half of the weight tile this thread converts
  const int cn = tid & 127, ch = tid >> 7;
  const uint32_t b_addr = base + Pf::B_OFF;

  float acc[64], p[64];
  uint32_t a[8][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) p[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0u;

  auto promote = [&](float s0, float s1) {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      acc[4 * n + 0] = fmaf(p[4 * n + 0], s0, acc[4 * n + 0]);
      acc[4 * n + 1] = fmaf(p[4 * n + 1], s0, acc[4 * n + 1]);
      acc[4 * n + 2] = fmaf(p[4 * n + 2], s1, acc[4 * n + 2]);
      acc[4 * n + 3] = fmaf(p[4 * n + 3], s1, acc[4 * n + 3]);
    }
  };

  int s = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    int mt, nt;
    pf_tile(i / splits, MB, NB, mt, nt);
    const int j = i % splits;
    const int k0 = j * KB / splits, k1 = (j + 1) * KB / splits;
    const int m0 = mt * BLOCK, n0 = nt * BLOCK;
    const int row0 = m0 + ra, row1 = row0 + 8;
#pragma unroll
    for (int k = 0; k < 64; ++k) acc[k] = 0.f;
    float sc0 = 0.f, sc1 = 0.f;        // the scales of the group in flight

    for (int kb = k0; kb < k1; ++kb, ++s) {
      const int slot = s % PF_STAGES;
      mbar_wait(full + 8 * slot, (s / PF_STAGES) & 1);
      const uint8_t* xt = smem + slot * Pf::STAGE;
      const uint8_t* wt = xt + Pf::X_BYTES;

      // 1. weight row cn, half ch -> the fp16 B tile of this group: chunk
      //    2j of the converted row holds the low code pairs of the words j
      //    of the row's four source chunks, chunk 2j + 1 the high pairs
      {
        uint4 src[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) src[q] = chunk(wt, cn, 4 * ch + q);
        const uint32_t w[4][4] = {{src[0].x, src[0].y, src[0].z, src[0].w},
                                  {src[1].x, src[1].y, src[1].z, src[1].w},
                                  {src[2].x, src[2].y, src[2].z, src[2].w},
                                  {src[3].x, src[3].y, src[3].z, src[3].w}};
        uint8_t* row = smem + Pf::B_OFF +
                       (s & 1) * Pf::B_BYTES + ch * Pf::B_HALF + cn * 128;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint4 lo = make_uint4(cvt2(w[0][j]), cvt2(w[1][j]),
                                      cvt2(w[2][j]), cvt2(w[3][j]));
          const uint4 hi = make_uint4(cvt2(w[0][j] >> 16), cvt2(w[1][j] >> 16),
                                      cvt2(w[2][j] >> 16), cvt2(w[3][j] >> 16));
          *reinterpret_cast<uint4*>(row + (((2 * j) ^ (cn & 7)) << 4)) = lo;
          *reinterpret_cast<uint4*>(row + (((2 * j + 1) ^ (cn & 7)) << 4)) = hi;
        }
      }
      // 2. this group's scales, from the stage (used once its product is
      //    done)
      const float* sc = reinterpret_cast<const float*>(xt + Pf::SC_OFF);
      const float wsv = sc[BLOCK], x0 = sc[ra], x1 = sc[ra + 8];
      // 3. the previous group's product: wait, promote
      if (kb > k0) {
        wgmma_wait<0>();
        fence_regs(p);
        fence_regs(a);
        promote(sc0, sc1);
      }
      // 4. this group's A fragments, from the x box
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t f[4][4];
        frags(chunk(xt, ra, 4 * h + t), chunk(xt, ra + 8, 4 * h + t), f);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) a[4 * h + j][r] = f[j][r];
      }
      fence_proxy_async();             // the B stores, before wgmma reads
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * slot);
      // both warpgroups' halves of the B tile are written, and both have
      // finished the product that read this B buffer two groups ago
      bar_sync(1, 256);
      wgmma_fence();
      const uint32_t bt = b_addr + (s & 1) * Pf::B_BYTES;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wgmma_rs_f16_n128(
            p, a[j],
            smem_desc(bt + (j >> 2) * Pf::B_HALF + (j & 3) * 32, 16, 1024, 1),
            j > 0);
      wgmma_commit();
      sc0 = x0 * wsv;
      sc1 = x1 * wsv;
    }
    wgmma_wait<0>();
    fence_regs(p);
    fence_regs(a);
    promote(sc0, sc1);

    // epilogue: rows row0 (acc[4n], [4n+1]) and row1 ([4n+2], [4n+3]),
    // columns n0 + 8n + 2t and + 1; into y, or this item's partial slab
    if (splits > 1) {
      float* pt = part + (static_cast<size_t>(nt) * splits + j) * M * BLOCK;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = h ? row1 : row0;
          if (row < M)
            *reinterpret_cast<float2*>(pt + static_cast<size_t>(row) * BLOCK +
                                       8 * n + 2 * t) =
                make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
        }
      continue;
    }
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = n0 + 8 * n + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h ? row1 : row0;
        if (row >= M || col >= N) continue;
        float* out = y + static_cast<size_t>(row) * N + col;
        const float v0 = acc[4 * n + 2 * h], v1 = acc[4 * n + 2 * h + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          out[0] = v0;
          if (col + 1 < N) out[1] = v1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Weight maps, encoded once per (storage, shape, row stride): a map is a
// function of these alone, so an entry is never stale. The cache keeps the
// MAP_CACHE most recently used maps (128 bytes each): more than every linear
// of a served model, while weights made per call (fp8_matmul on a plain
// tensor, clones in tests) push out the oldest entries instead of growing
// the process without bound.
constexpr size_t MAP_CACHE = 4096;

struct MapKey {
  uintptr_t ptr;
  int n, k;
  long ld;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && n == o.n && k == o.k && ld == o.ld;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& key) const {
    return std::hash<uintptr_t>()(key.ptr) ^
           (std::hash<long>()(key.ld) * 31 + key.n * 7 + key.k);
  }
};

CUresult weight_map(EncodeTiled enc, CUtensorMap* out, const void* wq, int N,
                    int K, long ldw) {
  using Entry = std::pair<MapKey, CUtensorMap>;
  static std::mutex mu;
  static std::list<Entry> lru;    // most recently used first
  static std::unordered_map<MapKey, std::list<Entry>::iterator, MapKeyHash>
      index;
  const MapKey key{reinterpret_cast<uintptr_t>(wq), N, K, ldw};
  std::lock_guard<std::mutex> lock(mu);
  auto it = index.find(key);
  if (it != index.end()) {
    lru.splice(lru.begin(), lru, it->second);
    *out = it->second->second;
    return CUDA_SUCCESS;
  }
  const CUresult r = map_bytes_2d(enc, out, wq, K, N, ldw, BLOCK);
  if (r != CUDA_SUCCESS) return r;
  if (lru.size() == MAP_CACHE) {
    index.erase(lru.back().first);
    lru.pop_back();
  }
  lru.emplace_front(key, *out);
  index.emplace(key, lru.begin());
  return r;
}

template <int NT8>
int launch_decode(const CUtensorMap& tw, const void* xq, const void* xs,
                  const void* ws, void* y, void* part, int M, int N, int K,
                  int grid, int per, int maxc, EncodeTiled enc,
                  cudaStream_t stream) {
  using S = Dec<NT8>;
  CUtensorMap tx;
  const CUresult r = map_bytes_2d(enc, &tx, xq, K, M, K, S::XR);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  static const cudaError_t attr = cudaFuncSetAttribute(
      fp8_gemm_decode_kernel<NT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  fp8_gemm_decode_kernel<NT8><<<grid, DEC_THREADS, S::SMEM, stream>>>(
      tx, tw, static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<float*>(part), M, N, K, per, maxc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long total = static_cast<long>(M) * N;
  fp8_gemm_reduce_kernel<<<static_cast<int>((total + 255) / 256), 256, 0,
                           stream>>>(static_cast<const float*>(part),
                                     static_cast<float*>(y), M, N, K / BLOCK,
                                     per, maxc);
  return static_cast<int>(cudaGetLastError());
}

int launch_prefill(const CUtensorMap& tw, const void* xq, const void* xs,
                   const void* ws, void* y, void* part, int M, int N, int K,
                   int grid, int splits, EncodeTiled enc,
                   cudaStream_t stream) {
  CUtensorMap tx;
  const CUresult r = map_bytes_2d(enc, &tx, xq, K, M, K, BLOCK);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  static const cudaError_t attr = cudaFuncSetAttribute(
      fp8_gemm_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Pf::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  fp8_gemm_prefill_kernel<<<grid, PF_THREADS, Pf::SMEM, stream>>>(
      tx, tw, static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<float*>(y), static_cast<float*>(part), M, N, K, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long total = static_cast<long>(M) * N;
  fp8_gemm_reduce_kernel<<<static_cast<int>((total + 255) / 256), 256, 0,
                           stream>>>(static_cast<const float*>(part),
                                     static_cast<float*>(y), M, N, K / BLOCK,
                                     0, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (M,N) fp32 = (xq * xs) @ (wq * ws); see the head comment for the
// layouts. The launch plan comes from the wrapper: mode 0 (decode, M <= 64:
// `grid` CTAs of `per` units each, at most `maxc` of them a tile) or 1
// (prefill: `grid` persistent CTAs over the tiles, each tile's K split
// `maxc` ways; `per` is 0). `part` is a workspace of ceil(N/128) * maxc *
// M * 128 floats (unused by an unsplit prefill). Returns a CUDA error
// code; negative: the driver refused a TMA tensor map.
extern "C" int fp8_gemm(const void* xq, const void* xs, const void* wq,
                        const void* ws, void* y, void* part, int M, int N,
                        int K, long ldw, int mode, int grid, int per,
                        int maxc, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BLOCK || ldw < K || ldw % 16 ||
      grid <= 0 || maxc <= 0 || (mode == 0 && (M > 64 || per <= 0)) ||
      (mode == 1 && maxc > K / BLOCK) || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tw;
  const CUresult r = weight_map(enc, &tw, wq, N, K, ldw);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1)
    return launch_prefill(tw, xq, xs, ws, y, part, M, N, K, grid, maxc, enc,
                          s);
  switch ((M + 7) / 8) {
    case 1: return launch_decode<1>(tw, xq, xs, ws, y, part, M, N, K, grid, per, maxc, enc, s);
    case 2: return launch_decode<2>(tw, xq, xs, ws, y, part, M, N, K, grid, per, maxc, enc, s);
    case 3: return launch_decode<3>(tw, xq, xs, ws, y, part, M, N, K, grid, per, maxc, enc, s);
    case 4: return launch_decode<4>(tw, xq, xs, ws, y, part, M, N, K, grid, per, maxc, enc, s);
    case 5: return launch_decode<5>(tw, xq, xs, ws, y, part, M, N, K, grid, per, maxc, enc, s);
    case 6: return launch_decode<6>(tw, xq, xs, ws, y, part, M, N, K, grid, per, maxc, enc, s);
    case 7: return launch_decode<7>(tw, xq, xs, ws, y, part, M, N, K, grid, per, maxc, enc, s);
    default: return launch_decode<8>(tw, xq, xs, ws, y, part, M, N, K, grid, per, maxc, enc, s);
  }
}
