// Grouped expert GEMM for Hopper (sm_90a), in two weight formats.
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm/moe_gemm.py:moe_gemm.
//   y[e] = x[e] @ w[e]   x (E,C,D) bf16 -> y (E,C,F) bf16, fp32 accumulation
// with w either
//   fmt 0  bf16 (E,D,F), D % 64 == 0, F % 128 == 0 (the wrapper pads), or
//   fmt 1  E4M3 codes in 128x128 blocks (E, F/128, D/128, 128 f, 128 d),
//          each block's 16-byte chunks swizzled (chunk c of row f stored at
//          c ^ 4(f & 1)), with fp32 scales (E, D/128, F/128): the weight is
//          bf16(code x scale), the value the reference's straight-through
//          block qdq gives. core/fp8.Fp8Experts makes this layout at load.
// x rows are D elements long (the wrapper pads D to the weight's depth).
//
// Bound on an H100: bytes at every main-path shape. At decode C = 8, so a
// call streams the whole expert wall (256 x 7168 x 2048 weights) at ~16
// flops per bf16 weight byte; at C = 40 (the 1024-token prefill bucket) the
// bf16 tensor work is ~0.3 ms under a ~1.2 ms byte time. So the design
// keeps HBM streaming and reads each weight once:
//   * persistent CTAs walk the (expert, 128-wide F tile[, C tile]) list,
//     expert-major, so the CTAs in flight share their experts' x rows in
//     L2;
//   * a producer warp keeps a ring of up to 8 stages in flight with bulk
//     (TMA) copies completing on mbarriers, across tile boundaries: 16 KB
//     of weights a stage (one 128x128 code block, contiguous in the block
//     layout, so a CTA streams its tile's 917 KB in order; or two 64 x 64
//     TMA boxes of bf16), the tile's x rows (TMA boxes; rows past C arrive
//     as zeros), and the block's scale (a 4-byte cp.async whose completion
//     the stage's barrier counts). Eight consumer warps wait on a stage,
//     read it, and release it;
//   * two CTAs share an SM up to C = 40: 16 consumer warps hide the
//     latency of the dequant's dependent chains, which 8 do not;
//   * a CTA holds all C rows of its tile (up to 128; beyond that the C
//     tiles of one F tile re-read its weights, at >= 256 flops per code
//     byte, near the ridge), so no weight is read twice for C <= 128;
//   * the weight is the 16-row A operand of mma.sync.m16n8k16 (y^T = w^T
//     x^T): each consumer warp owns 16 of the tile's 128 F columns, and C
//     fills N in steps of 8, so decode (C = 8) pads nothing;
//   * codes: K is permuted inside each 16-deep MMA step, the same way for
//     both operands (a sum does not care), so a thread's A registers hold
//     4 consecutive d of one F column and one 16-byte read of a code row
//     feeds four MMAs. Codes are dequantized in registers to the exact
//     bf16 weight: E4M3 -> f16x2 (cvt.rn.f16x2.e4m3x2, exact), f16 ->
//     f32, a multiply by the block scale in fp32 (mul.rn, never
//     contracted), one rounding to bf16 (cvt.rn.bf16x2.f32). bf16 x bf16
//     products are exact in fp32, so the result matches an fp32 product of
//     the dequantized weights up to the order of the sums; the sum rounds
//     to bf16 once, at the store;
//   * bf16 weights: natural K order, A by ldmatrix.trans from [k][f] rows.
// Every shared-memory read of a warp is free of bank conflicts (the code
// layout's chunk swizzle; the TMA's 128-byte swizzle for x and bf16
// weights).
#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int BN = 128;        // F columns per tile (one scale block wide)
constexpr int WARPS = 8;       // consumer warps, 16 of a tile's F columns each
constexpr int THREADS = (WARPS + 1) * 32;   // + one producer warp

// A stage: the weight tile, the tile's x rows, the block scale; every
// region starts on 1024 bytes (the 128-byte TMA swizzle's period).
// fmt 1: 128 (K) x 128 (F) codes, [f][k] rows of 128 B, chunk-swizzled in
//        global memory already, so one bulk copy of 16 KB lands it; x as
//        two 64-deep halves, each CR rows of 128 B;
// fmt 0: 64 (K) x 128 (F) bf16 as two 64-wide F halves, each 64 k rows of
//        128 B; x as one 64-deep box of CR rows of 128 B.
// TMA boxes land 128-byte-swizzled: chunk c of row r at c ^ (r & 7).
// Two CTAs share an SM where their registers fit (C <= 40, the main path's
// shapes).
template <int FMT, int NT>
struct Stage {
  static constexpr int CTAS = NT <= 5 ? 2 : 1;
  static constexpr int BUDGET = CTAS == 2 ? 113664 : 215040;  // of 228 KB
  static constexpr int BK = FMT ? 128 : 64;
  static constexpr int CR = NT * 8;                    // C rows per tile
  static constexpr int W_BYTES = 16384;
  static constexpr int X_HALF = CR * 128;               // one 64-deep box
  static constexpr int X_BYTES = (BK / 64) * X_HALF;
  static constexpr int TX = W_BYTES + X_BYTES;          // bytes per stage
  static constexpr int BYTES = (TX + 16 + 1023) / 1024 * 1024;  // + scale
  static constexpr int COUNT = BUDGET / BYTES > 8 ? 8 : BUDGET / BYTES;
  static constexpr int SMEM = 1024 + COUNT * BYTES + 2 * 8 * COUNT;
  static_assert(COUNT >= 2, "the ring needs two stages");
  static_assert(X_HALF % 1024 == 0, "boxes keep the swizzle's alignment");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// One bulk copy of `bytes` contiguous bytes, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One TMA box of a 3-D map at coordinates (c0, c1, c2), completing on `bar`
// (rows past the tensor's end arrive as zeros and still count).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar) : "memory");
}

// The block scale: a 4-byte cp.async whose completion is one arrival on
// `bar` (the barrier counts it).
__device__ __forceinline__ void scale_load(uint32_t dst, const float* src,
                                           uint32_t bar) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src) : "memory");
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&d)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t out;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(out) : "f"(hi), "f"(lo));
  return out;
}

// Four E4M3 codes (the bytes of `u`, lowest first) -> two bf16x2
// registers, {b0, b1} and {b2, b3}, each bf16(fp32(code) * s) rounded once:
// the stored weight's exact value. E4M3 -> f16x2 (cvt.rn.f16x2.e4m3x2) and
// f16 -> f32 are exact; the multiply rounds once (mul.rn, never
// contracted into an FMA), then cvt.rn.bf16x2.f32.
__device__ __forceinline__ void dequant4(uint32_t u, float s, uint32_t& lo,
                                         uint32_t& hi) {
  uint32_t out[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    uint32_t h2;
    float a, b;
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n"
        : "=r"(h2) : "h"(static_cast<uint16_t>(u >> (16 * k))));
    asm("{\n.reg .f16 fa, fb;\nmov.b32 {fa, fb}, %2;\n"
        "cvt.f32.f16 %0, fa;\ncvt.f32.f16 %1, fb;\n}\n"
        : "=f"(a), "=f"(b) : "r"(h2));
    out[k] = pack_bf16x2(__fmul_rn(a, s), __fmul_rn(b, s));
  }
  lo = out[0];
  hi = out[1];
}

struct Tile {
  int e, f0, c0;
};

template <int FMT, int NT>
__global__ void __launch_bounds__(THREADS, (Stage<FMT, NT>::CTAS))
moe_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_w,
                const uint8_t* __restrict__ wq, const float* __restrict__ ws,
                __nv_bfloat16* __restrict__ y, int E, int C, int D, int F) {
  using S = Stage<FMT, NT>;
  constexpr int BK = S::BK, CR = S::CR;
  extern __shared__ uint8_t smem_raw[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int FT = F / BN, CT = (C + CR - 1) / CR, KT = D / BK;
  const int tiles = E * FT * CT;
  const int mine = (tiles - static_cast<int>(blockIdx.x) +
                    static_cast<int>(gridDim.x) - 1) / gridDim.x;
  const long total = static_cast<long>(mine) * KT;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full = base + S::COUNT * S::BYTES;    // mbarriers
  const uint32_t empty = full + 8 * S::COUNT;

  auto tile_of = [&](long s) {
    const int tt = blockIdx.x + static_cast<int>(s / KT) * gridDim.x;
    const int e = tt / (FT * CT), r = tt % (FT * CT);
    return Tile{e, (r / CT) * BN, (r % CT) * CR};
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::COUNT; ++i) {
      mbar_init(full + 8 * i, FMT ? 2 : 1);   // expect_tx (+ the scale)
      mbar_init(empty + 8 * i, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {
    // producer: one lane keeps the ring up to COUNT stages ahead of the
    // consumers, across tile boundaries
    if (lane != 0) return;
    for (long s = 0; s < total; ++s) {
      const int slot = static_cast<int>(s % S::COUNT);
      const int round = static_cast<int>(s / S::COUNT);
      if (round > 0) mbar_wait(empty + 8 * slot, (round - 1) & 1);
      const Tile tl = tile_of(s);
      const int kb = static_cast<int>(s % KT), k0 = kb * BK;
      const uint32_t st = base + slot * S::BYTES, bar = full + 8 * slot;
      mbar_arrive_tx(bar, S::TX);
      if (FMT) {
        const size_t blk = (static_cast<size_t>(tl.e) * FT + tl.f0 / BN)
                           * KT + kb;
        bulk_load(st, wq + blk * S::W_BYTES, S::W_BYTES, bar);
        scale_load(st + S::W_BYTES + S::X_BYTES,
                   ws + (static_cast<size_t>(tl.e) * KT + kb) * FT
                      + tl.f0 / BN, bar);
      } else {
        tma_load(st, &tm_w, bar, tl.f0, k0, tl.e);
        tma_load(st + 8192, &tm_w, bar, tl.f0 + 64, k0, tl.e);
      }
#pragma unroll
      for (int h = 0; h < BK / 64; ++h)
        tma_load(st + S::W_BYTES + h * S::X_HALF, &tm_x, bar, k0 + 64 * h,
                 tl.c0, tl.e);
    }
    return;
  }

  // consumers: warp w owns F rows 16w .. 16w + 15 of each tile
  const int g = lane >> 2, t = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;

  for (long s = 0; s < total; ++s) {
    const int slot = static_cast<int>(s % S::COUNT);
    mbar_wait(full + 8 * slot, static_cast<int>(s / S::COUNT) & 1);
    const uint8_t* sp = smem + slot * S::BYTES;
    const uint8_t* xp = sp + S::W_BYTES;

    if (FMT) {
      // K is permuted inside each k16 MMA step, the same for both
      // operands: thread t's registers of MMA j over d = 64h + [0, 64)
      // hold d = 64h + 16t + 4j + [0, 4), so one 16-byte read of a code row
      // (and two of an x row) feed the four MMAs
      const float sc =
          *reinterpret_cast<const float*>(sp + S::W_BYTES + S::X_BYTES);
      const int f = warp * 16 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // rows f and f+1 sit in opposite halves of their 128 B (the
        // global layout's chunk swizzle), so a quarter-warp's two rows
        // never share a bank
        const int ch = ((4 * h + t) ^ ((f & 1) << 2)) << 4;
        const uint4 lo = *reinterpret_cast<const uint4*>(sp + f * 128 + ch);
        const uint4 hi =
            *reinterpret_cast<const uint4*>(sp + (f + 8) * 128 + ch);
        const uint32_t l[4] = {lo.x, lo.y, lo.z, lo.w};
        const uint32_t u[4] = {hi.x, hi.y, hi.z, hi.w};
        uint32_t a[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dequant4(l[j], sc, a[j][0], a[j][2]);
          dequant4(u[j], sc, a[j][1], a[j][3]);
        }
        const uint8_t* xh = xp + h * S::X_HALF;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          // d = 16t + [0, 16) of this half: 16-byte chunks 2t, 2t+1 of
          // x row 8n + g, swizzled by the row
          const uint8_t* xr = xh + (n * 8 + g) * 128;
          const uint4 v0 = *reinterpret_cast<const uint4*>(
              xr + (((2 * t) ^ g) << 4));
          const uint4 v1 = *reinterpret_cast<const uint4*>(
              xr + (((2 * t + 1) ^ g) << 4));
          const uint32_t b[4][2] = {{v0.x, v0.y}, {v0.z, v0.w},
                                    {v1.x, v1.y}, {v1.z, v1.w}};
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[n], a[j], b[j]);
        }
      }
    } else {
      // natural K order: ldmatrix.trans reads A from the [k][f] rows of
      // this warp's F half, B is two 32-bit reads of an x row
      const int q = lane >> 3, i = lane & 7;
      const uint32_t wst = base + slot * S::BYTES + (warp >> 2) * 8192;
      const int c = 2 * (warp & 3) + (q & 1);       // 8-column chunk
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t a[4];
        const int k = 16 * j + 8 * (q >> 1) + i;   // k & 7 == i
        ldmatrix_x4_trans(a, wst + k * 128 + ((c ^ i) << 4));
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint8_t* xr = xp + (n * 8 + g) * 128 + 4 * t;
          const uint32_t b[2] = {
              *reinterpret_cast<const uint32_t*>(xr + (((2 * j) ^ g) << 4)),
              *reinterpret_cast<const uint32_t*>(
                  xr + (((2 * j + 1) ^ g) << 4))};
          mma_bf16_16816(acc[n], a, b);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot);    // the stage is read

    if (s % KT == KT - 1) {          // the tile's last depth step: store
      const Tile tl = tile_of(s);
      const int f = tl.f0 + warp * 16 + g;
      __nv_bfloat16* ye = y + static_cast<size_t>(tl.e) * C * F;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = tl.c0 + n * 8 + 2 * t;
        if (c < C) {
          ye[static_cast<size_t>(c) * F + f] = __float2bfloat16_rn(acc[n][0]);
          ye[static_cast<size_t>(c) * F + f + 8] =
              __float2bfloat16_rn(acc[n][2]);
        }
        if (c + 1 < C) {
          ye[static_cast<size_t>(c + 1) * F + f] =
              __float2bfloat16_rn(acc[n][1]);
          ye[static_cast<size_t>(c + 1) * F + f + 8] =
              __float2bfloat16_rn(acc[n][3]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver the runtime has loaded, so the
// library needs no link against libcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 3-D bf16 map over (inner, rows, batch) of a contiguous (batch, rows,
// inner) tensor, boxes of `box_rows` x 64 elements (128 B), 128-byte
// swizzled; rows past the end read as zeros.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                  int inner, int rows, int batch, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(inner) * 2;
  const cuuint64_t strides[2] = {row, row * rows};
  const cuuint32_t boxes[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, boxes, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// Returns a CUDA error code, or -(CUresult) if the driver refused a map.
template <int FMT, int NT>
int launch(const void* x, const void* w, const void* ws, void* y, int E,
           int C, int D, int F, cudaStream_t stream) {
  using S = Stage<FMT, NT>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tx, tw;
  CUresult r = make_map(enc, &tx, x, D, C, E, S::CR);
  if (FMT)
    tw = tx;          // codes come by bulk copies; the weight map is unused
  else if (r == CUDA_SUCCESS)
    r = make_map(enc, &tw, w, F, D, E, 64);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  static const cudaError_t attr = cudaFuncSetAttribute(
      moe_gemm_kernel<FMT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = E * (F / BN) * ((C + S::CR - 1) / S::CR);
  const int slots = S::CTAS * sm_count();
  const int grid = tiles < slots ? tiles : slots;
  moe_gemm_kernel<FMT, NT><<<grid, THREADS, S::SMEM, stream>>>(
      tx, tw, static_cast<const uint8_t*>(w), static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(y), E, C, D, F);
  return static_cast<int>(cudaGetLastError());
}

template <int FMT>
int dispatch(const void* x, const void* w, const void* ws, void* y, int E,
             int C, int D, int F, cudaStream_t stream) {
  // n8 tiles of C per CTA: exact up to 6, then 8, then 16 (C > 128 takes
  // several C tiles)
  switch ((C + 7) / 8) {
    case 1: return launch<FMT, 1>(x, w, ws, y, E, C, D, F, stream);
    case 2: return launch<FMT, 2>(x, w, ws, y, E, C, D, F, stream);
    case 3: return launch<FMT, 3>(x, w, ws, y, E, C, D, F, stream);
    case 4: return launch<FMT, 4>(x, w, ws, y, E, C, D, F, stream);
    case 5: return launch<FMT, 5>(x, w, ws, y, E, C, D, F, stream);
    case 6: return launch<FMT, 6>(x, w, ws, y, E, C, D, F, stream);
    case 7:
    case 8: return launch<FMT, 8>(x, w, ws, y, E, C, D, F, stream);
    default: return launch<FMT, 16>(x, w, ws, y, E, C, D, F, stream);
  }
}

}  // namespace

// x (E,C,D) bf16; w bf16 (E,D,F) [fmt 0] or E4M3 blocks [fmt 1]; ws fp32
// (E,D/128,F/128) [fmt 1] or null; y (E,C,F) bf16. D is the padded depth
// (a multiple of 64 for fmt 0, of 128 for fmt 1), F a multiple of 128.
// Returns a CUDA error code; negative: the driver refused a TMA tensor map.
extern "C" int moe_gemm(const void* x, const void* w, const void* ws, void* y,
                        int E, int C, int D, int F, int fmt, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0 || D <= 0 || F % BN ||
      D % (fmt ? 128 : 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fmt ? dispatch<1>(x, w, ws, y, E, C, D, F, s)
             : dispatch<0>(x, w, ws, y, E, C, D, F, s);
}
