// Flash bucketed-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py:flash_prefill_kernel (pallas_call at :109). For batch
// b, query row r and query head h (KV head h / G, G = H / KV):
//   s_t = (q[b,r,h]·k[b,t,h/G]) * scale
//   valid_t = k_pos[b,t] >= 0 && (!causal || k_pos[b,t] <= q_pos[b,r])
//   o[b,r,h] = sum_t softmax over valid t (s)_t * v[b,t,h/G]   (fp32)
// and a row with no valid key gives zeros (the empty online softmax), as
// the reference does. q (B,S,H,hd), k/v (B,T,KV,hd) in the compute dtype,
// positions int32, out (B,S,H,hd) fp32.
//
// What bounds it on an H100: causal prefill of a 2048 bucket at 40 heads
// of 128 is 4.3e10 FLOP against ~50 MB of operands and output, so the bf16
// tensor cores bound it: 0.0434 ms at 989 TFLOP/s. Reaching them takes
// wgmma (mma.sync runs at a fraction of the rate), operands that arrive
// while the tensor cores work, the softmax hidden under the products, and
// no idle gap between one query tile and the next.
//
// * bf16 operands (hd 32, 64, 128; scale > 0): persistent CTAs, one per
//   SM, of three warpgroups. The work is a list of (128-row query tile,
//   batch, head) tiles, heaviest first (causal: the last query tiles);
//   CTA c takes tiles c, 2G - 1 - c, 2G + c, ... (a snake over rounds of G
//   CTAs), so every CTA gets about the same number of key blocks.
//   - The producer warpgroup gives up its registers (setmaxnreg.dec); one
//     warp of it walks each tile's key blocks. It loads the block's 128
//     key positions itself (-1 past T), skips a block in which no key is
//     valid for the tile's largest q_pos (the upper triangle of causal
//     prefill, all-pad blocks; no order of the positions is assumed), and
//     for the others waits for a free stage of a ring of STAGES, stores
//     the positions and {block, least and largest position} there, and has
//     one thread issue the TMA loads of the K and V tiles, completing on
//     the stage's full mbarrier. A stage with block -1 ends the tile. Q is
//     one buffer, refilled once the consumers' last Q·Kᵀ of the previous
//     tile is done (its own full/empty mbarriers), after the next tile's
//     first K/V block is on its way.
//   - The tensor maps are 4-D over (hd, heads, seq, batch), so q, k and v
//     are read in place; TMA fills rows past S or T with zeros and lays
//     each tile out with the swizzle wgmma reads: 128 B rows (hd 64, and
//     hd 128 as two 64-column boxes) or 64 B rows (hd 32).
//   - Two consumer warpgroups (setmaxnreg.inc) own 64 query rows each.
//     Per block: S = Q·Kᵀ by wgmma m64n128k16, both operands in shared
//     memory (K stored key-major, as B wants it for this product); the
//     online softmax on the accumulator layout in the log2 domain, with
//     scale·log2 e folded into the exponent's FFMA and ex2.approx, masked
//     from q_pos and k_pos only where the block is not valid throughout;
//     P rounded to bf16 into A fragments in registers (l sums the
//     unrounded fp32 P); O += P·V by wgmma m64n{hd}k16 with V read in its
//     stored [key][hd] layout through the transposed-B bit.
//   - The products overlap the softmax two ways: within a warpgroup, S of
//     block j is issued together with P·V of block j - 1, so the softmax
//     of j runs under that P·V (a warpgroup holds two stages, hence three
//     in the ring); and the two warpgroups take turns to issue (named
//     barriers), so one's softmax runs under the other's products.
// * fp32 operands: CUDA-core fp32 FMAs (no TF32, no bf16 rounding), 16
//   query rows x 32-key blocks, one (row, key) score per thread. hd <= 256.
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// reached through the runtime's CUDA-driver entry point (no -lcuda), and
// passed as __grid_constant__ kernel parameters.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ bool key_valid(int kp, int qp, bool causal) {
  return kp >= 0 && (!causal || kp <= qp);
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA ring, warp-specialised
// ---------------------------------------------------------------------------

constexpr int BQ = 128;              // query rows per CTA (64 per consumer)
constexpr int BK = 128;              // keys per stage
constexpr int STAGES = 3;            // K/V ring; a consumer holds two at once
constexpr int THREADS = 384;         // consumer WG 0, 1; producer WG 2
constexpr int PRODUCER_REGS = 24;    // 24 * 128 + 240 * 256 = 168 * 384
constexpr int CONSUMER_REGS = 240;

// Shared-memory layout of one CTA, offsets from a 1024-byte aligned base:
// Q tile, then per stage the K tile and the V tile, each as NBOX boxes of
// rows x BOX columns (one swizzle row of ROWB bytes per tensor row), then
// per stage the key positions and {block index, least and largest key
// position, 0}, then the mbarriers.
template <int HD>
struct Layout {
  static constexpr int BOX = HD < 64 ? HD : 64;
  static constexpr int NBOX = HD / BOX;
  static constexpr int ROWB = 2 * BOX;               // 64 or 128 bytes
  static constexpr int ATOM = 8 * ROWB;              // one swizzle atom
  static constexpr uint64_t SWIZZLE = ROWB == 128 ? 1 : 2;  // wgmma mode
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;       // K or V, one stage
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int KPOS_OFF = K_OFF + STAGES * STAGE_BYTES;
  static constexpr int INFO_OFF = KPOS_OFF + STAGES * BK * 4;
  static constexpr int BAR_OFF = INFO_OFF + 16 * STAGES;
  // full[STAGES], empty[STAGES], q_full, q_empty
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 2);
  static constexpr size_t smem() { return BYTES + 1024; }   // + alignment
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0,
                "tiles must keep 1024-byte swizzle alignment");
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

// Wait until the phase of the given parity has completed (the spin stays
// inside the asm, so the warp reaches the next instruction converged).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// One TMA box of a 4-D map at coordinates (c0, c1, c2, c3), completing on
// `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swz) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swz << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep accumulators in place across the asynchronous wgmma (no moves of
// registers the tensor cores are writing).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x on the special-function unit; subnormal results flush to zero (a
// probability below 2^-126 of the row's largest).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers 1 and 2 order the two consumer warpgroups' wgmma issues.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// One online-softmax step for this thread's rows g and g + 8 over a block
// of BK scores in the wgmma accumulator layout (per 8-column slab n:
// s[4n], s[4n+1] row g, s[4n+2], s[4n+3] row g + 8, columns 8n + 2·t4
// and + 1). m is kept in the log2 domain, c = scale·log2 e > 0 is folded
// into the exponent's FFMA: P = 2^(s·c - m). A key is valid for a row iff
// kp >= 0 && kp <= the row's limit; `full` says every key of the block is
// valid for every row of the warp (no mask to apply). Leaves P in s
// (fp32), updates m and l (this lane's partial sum), and returns the
// factors that rescale O.
template <int BKN>
__device__ __forceinline__ float2 softmax_step(float (&s)[BKN / 2],
                                               const int* kps, int t4,
                                               bool full, int lim0, int lim1,
                                               float c, float& m0, float& m1,
                                               float& l0, float& l1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
  if (!full) {
#pragma unroll
    for (int n = 0; n < BKN / 8; ++n) {
      const int2 kp = *reinterpret_cast<const int2*>(kps + n * 8 + 2 * t4);
      const bool ok0 = kp.x >= 0, ok1 = kp.y >= 0;
      float* d = s + 4 * n;
      d[0] = ok0 && kp.x <= lim0 ? d[0] : -INFINITY;
      d[1] = ok1 && kp.y <= lim0 ? d[1] : -INFINITY;
      d[2] = ok0 && kp.x <= lim1 ? d[2] : -INFINITY;
      d[3] = ok1 && kp.y <= lim1 ? d[3] : -INFINITY;
    }
  }
#pragma unroll
  for (int n = 0; n < BKN / 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0 * c), mn1 = fmaxf(m1, mx1 * c);
  // a row with no valid key yet keeps m = -inf; subtract 0 instead
  const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
  const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
  const float a0 = ex2(m0 - mu0), a1 = ex2(m1 - mu1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < BKN / 8; ++n) {
    float* d = s + 4 * n;
    d[0] = ex2(fmaf(d[0], c, -mu0));
    d[1] = ex2(fmaf(d[1], c, -mu0));
    d[2] = ex2(fmaf(d[2], c, -mu1));
    d[3] = ex2(fmaf(d[3], c, -mu1));
    sum0 += d[0] + d[1];
    sum1 += d[2] + d[3];
  }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
  return make_float2(a0, a1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// P (fp32, accumulator layout) rounded to the bf16 A fragments of P·V:
// k-step j takes slabs 2j (a0 row g, a1 row g + 8) and 2j + 1 (a2, a3).
template <int BKN>
__device__ __forceinline__ void pack_p(const float (&s)[BKN / 2],
                                       uint32_t (&pa)[BKN / 16][4]) {
#pragma unroll
  for (int n = 0; n < BKN / 8; ++n) {
    pa[n / 2][(n & 1) * 2 + 0] = pack_bf16(s[4 * n], s[4 * n + 1]);
    pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(s[4 * n + 2], s[4 * n + 3]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float2 a) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    o[4 * n + 0] *= a.x;
    o[4 * n + 1] *= a.x;
    o[4 * n + 2] *= a.y;
    o[4 * n + 3] *= a.y;
  }
}

// ---- wgmma: the two shapes of the product (generated register lists)

// D(64x128, fp32) (+)= A·B with A (64x16) and B (128x16, K-major)
// read from shared memory through descriptors; acc = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// O(64 x N, fp32) += P·V with P (64x16 bf16) in registers as A fragments
// and V (16 keys x N) in shared memory, MN-major (transposed-B bit).
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};


// The c-th of G persistent CTAs takes tiles c, 2G - 1 - c, 2G + c, ... of
// the heaviest-first order (query tiles descending, then batch, then head):
// a snake over the rounds evens out the causal tiles' unequal work.
__device__ __forceinline__ int tile_at(int round) {
  const int g = gridDim.x, c = blockIdx.x;
  return round * g + (round & 1 ? g - 1 - c : c);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ k_pos,
                          float* __restrict__ out, int B, int S, int T,
                          int H, int KV, int causal, float scale_log2) {
  using L = Layout<HD>;
  extern __shared__ unsigned char raw[];
  const uint32_t raw_addr = smem_u32(raw);
  unsigned char* base = raw + ((1024 - (raw_addr & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  int* kpos_s = reinterpret_cast<int*>(base + L::KPOS_OFF);   // [STAGES][BK]
  int4* info_s = reinterpret_cast<int4*>(base + L::INFO_OFF); // [STAGES]
  const uint32_t full_bar = sbase + L::BAR_OFF;
  const uint32_t empty_bar = full_bar + 8 * STAGES;
  const uint32_t q_full = empty_bar + 8 * STAGES;
  const uint32_t q_empty = q_full + 8;

  const int tid = threadIdx.x;
  const int nqt = (S + BQ - 1) / BQ;
  const int ntiles = nqt * B * H;
  const int G = H / KV;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 32);      // the producer warp's lanes
      mbar_init(empty_bar + 8 * s, 8);      // one per consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid < 256 + 32) {
      const int lane = tid - 256;
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0, t = tile_at(0); t < ntiles; t = tile_at(++i)) {
        const int q0 = (nqt - 1 - t / (B * H)) * BQ;
        const int b = t % (B * H) / H, h = t % H, kvh = h / G;
        // Q, once the consumers' last Q·Kᵀ of the previous tile is done:
        // sent after the tile's first K/V block (which does not wait for
        // it), or alone if no block is loaded
        bool q_sent = false;
        auto send_q = [&] {
          mbar_wait(q_empty, (i & 1) ^ 1);
          if (lane == 0) {
            mbar_arrive_tx(q_full, L::Q_BYTES);
            for (int c = 0; c < L::NBOX; ++c)
              tma_load(sbase + c * BQ * L::ROWB, &tm_q, q_full, c * L::BOX,
                       h, q0, b);
          }
          q_sent = true;
        };
        // the tile's largest query position decides which blocks to load
        int qmax = INT_MIN;
        for (int r = lane; r < BQ; r += 32)
          if (q0 + r < S)
            qmax = max(qmax, q_pos[static_cast<size_t>(b) * S + q0 + r]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
        const int nkb = (T + BK - 1) / BK;
        for (int j = 0; j < nkb; ++j) {
          int kp[BK / 32];
          bool any = false;
          int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
          for (int e = 0; e < BK / 32; ++e) {
            const int key = j * BK + e * 32 + lane;
            kp[e] = key < T ? k_pos[static_cast<size_t>(b) * T + key] : -1;
            any |= key_valid(kp[e], qmax, causal != 0);
            kmin = min(kmin, kp[e]);
            kmax = max(kmax, kp[e]);
          }
          if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, off));
            kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
          }
          mbar_wait(empty_bar + 8 * stage, phase ^ 1);
#pragma unroll
          for (int e = 0; e < BK / 32; ++e)
            kpos_s[stage * BK + e * 32 + lane] = kp[e];
          const uint32_t fb = full_bar + 8 * stage;
          if (lane == 0) {
            info_s[stage] = make_int4(j, kmin, kmax, 0);
            mbar_arrive_tx(fb, L::STAGE_BYTES);
            const uint32_t ks = sbase + L::K_OFF + stage * L::STAGE_BYTES;
            const uint32_t vs = ks + L::KV_BYTES;
            for (int c = 0; c < L::NBOX; ++c) {
              tma_load(ks + c * BK * L::ROWB, &tm_k, fb, c * L::BOX, kvh,
                       j * BK, b);
              tma_load(vs + c * BK * L::ROWB, &tm_v, fb, c * L::BOX, kvh,
                       j * BK, b);
            }
          } else {
            mbar_arrive(fb);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
          if (!q_sent) send_q();
        }
        if (!q_sent) send_q();
        // end of the tile's walk
        mbar_wait(empty_bar + 8 * stage, phase ^ 1);
        if (lane == 0) info_s[stage] = make_int4(-1, 0, 0, 0);
        mbar_arrive(full_bar + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    constexpr int NO = HD / 2;          // O accumulator registers
    constexpr int NKS = HD / 16;        // k-steps of Q·Kᵀ
    constexpr int NPV = BK / 16;        // k-steps of P·V
    const int wg = tid >> 7;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = wg * 64 + (warp & 3) * 16 + g;      // rows r0, r0 + 8

    float o[NO];
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    uint32_t pa[NPV][4];
    float m0, m1, l0, l1;
    int lim0, lim1, wlim;

    const uint32_t q_addr = sbase + wg * 64 * L::ROWB;   // this WG's rows
    const uint32_t k_addr = sbase + L::K_OFF;
    const uint32_t v_addr = k_addr + L::KV_BYTES;
    // S = Q·Kᵀ for the K tile of a stage: 64 rows x BK keys, k-steps of 16
    // along hd (32 bytes into a swizzled row, or the next 64-column box)
    auto issue_s = [&](int st) {
      const uint32_t kst = k_addr + st * L::STAGE_BYTES;
#pragma unroll
      for (int j = 0; j < NKS; ++j) {
        const int e = j * 16;
        const uint32_t col = (e % L::BOX) * 2;
        const uint64_t da = smem_desc(
            q_addr + (e / L::BOX) * BQ * L::ROWB + col, 16, L::ATOM,
            L::SWIZZLE);
        const uint64_t db = smem_desc(
            kst + (e / L::BOX) * BK * L::ROWB + col, 16, L::ATOM, L::SWIZZLE);
        wgmma_ss_n128(s, da, db, j > 0);
      }
      wgmma_commit();
    };
    // O += P·V for the V tile of a stage: V is B in its [key][hd] layout
    // (transposed-B), k-steps of 16 keys; LBO steps across 64-column
    // boxes, SBO across 8 keys
    auto issue_pv = [&](int st) {
      const uint32_t vst = v_addr + st * L::STAGE_BYTES;
#pragma unroll
      for (int j = 0; j < NPV; ++j) {
        const uint64_t db = smem_desc(vst + j * 16 * L::ROWB,
                                      BK * L::ROWB, L::ATOM, L::SWIZZLE);
        WgmmaRS<HD>::run(o, pa[j], db);
      }
      wgmma_commit();
    };
    auto softmax = [&](int st) {
      const int4 inf = info_s[st];
      const bool full = inf.y >= 0 && inf.z <= wlim;
      return softmax_step<BK>(s, kpos_s + st * BK, t4, full, lim0, lim1,
                              scale_log2, m0, m1, l0, l1);
    };
    auto arrive = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto advance = [](int& st, uint32_t& ph) {
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    };

    // Schedule. The two warpgroups take turns to issue their wgmma (named
    // barriers 1 + wg), so one's softmax runs under the other's products;
    // within a warpgroup, S of block j is issued together with P·V of
    // block j - 1, so the softmax of j runs under that P·V. Q is released
    // after a tile's last Q·Kᵀ, so the next tile's Q and first K/V blocks
    // load under its last P·V and its epilogue.
    const int me = 1 + wg, other = 2 - wg;
    if (wg == 1) bar_arrive(1);          // warpgroup 0 issues first
    // the query positions of this thread's rows of tile t, loaded a tile
    // ahead so their latency hides under the previous tile's last P·V
    int2 qp_next;
    auto load_qp = [&](int t) {
      if (t >= ntiles) return;
      const int q0 = (nqt - 1 - t / (B * H)) * BQ + r0;
      const int* qb = q_pos + static_cast<size_t>(t % (B * H) / H) * S;
      qp_next = make_int2(q0 < S ? qb[q0] : INT_MIN,
                          q0 + 8 < S ? qb[q0 + 8] : INT_MIN);
    };
    load_qp(tile_at(0));
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0, t = tile_at(0); t < ntiles; t = tile_at(++i)) {
      const int q0 = (nqt - 1 - t / (B * H)) * BQ;
      const int b = t % (B * H) / H, h = t % H;
      const int row0 = q0 + r0, row1 = row0 + 8;
      const int qp0 = qp_next.x, qp1 = qp_next.y;
      // a key is valid for a row iff kp >= 0 && kp <= its limit; a block
      // is valid throughout for this warp's 16 rows iff its least position
      // is >= 0 and its largest <= the least limit of the warp
      lim0 = causal ? qp0 : INT_MAX;
      lim1 = causal ? qp1 : INT_MAX;
      wlim = min(lim0, lim1);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        wlim = min(wlim, __shfl_xor_sync(0xffffffffu, wlim, off));
#pragma unroll
      for (int n = 0; n < NO; ++n) o[n] = 0.f;
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.f;

      mbar_wait(q_full, i & 1);
      mbar_wait(full_bar + 8 * stage, phase);
      if (info_s[stage].x >= 0) {
        fence_regs(s);
        bar_sync(me);
        wgmma_fence();
        issue_s(stage);
        bar_arrive(other);
        wgmma_wait<0>();
        fence_regs(s);
        softmax(stage);                  // O is 0: nothing to rescale
        pack_p<BK>(s, pa);
        int prev = stage;
        advance(stage, phase);
        for (;;) {
          mbar_wait(full_bar + 8 * stage, phase);
          if (info_s[stage].x < 0) break;
          fence_regs(s);
          fence_regs(o);
          fence_regs(pa);
          bar_sync(me);
          wgmma_fence();
          issue_s(stage);
          issue_pv(prev);
          bar_arrive(other);
          wgmma_wait<1>();               // S done; P·V may still run
          fence_regs(s);
          const float2 a = softmax(stage);
          wgmma_wait<0>();
          fence_regs(o);
          fence_regs(pa);                // A registers live until P·V is done
          arrive(empty_bar + 8 * prev);
          rescale(o, a);
          pack_p<BK>(s, pa);
          prev = stage;
          advance(stage, phase);
        }
        arrive(q_empty);                 // the tile's Q·Kᵀ are all done
        arrive(empty_bar + 8 * stage);   // the end-of-tile stage
        advance(stage, phase);
        load_qp(tile_at(i + 1));
        fence_regs(o);
        fence_regs(pa);
        bar_sync(me);
        wgmma_fence();
        issue_pv(prev);
        bar_arrive(other);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        arrive(empty_bar + 8 * prev);
      } else {
        arrive(q_empty);
        arrive(empty_bar + 8 * stage);
        advance(stage, phase);
        load_qp(tile_at(i + 1));
      }

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float d0 = 1.f / fmaxf(l0, 1e-30f), d1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
      for (int n = 0; n < NO / 4; ++n) {
        const int c = n * 8 + 2 * t4;
        if (row0 < S)
          *reinterpret_cast<float2*>(
              out + ((static_cast<size_t>(b) * S + row0) * H + h) * HD + c) =
              make_float2(o[4 * n] * d0, o[4 * n + 1] * d0);
        if (row1 < S)
          *reinterpret_cast<float2*>(
              out + ((static_cast<size_t>(b) * S + row1) * H + h) * HD + c) =
              make_float2(o[4 * n + 2] * d1, o[4 * n + 3] * d1);
      }
    }
    if (wg == 0) bar_sync(1);            // warpgroup 1's last turn
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ32 = 16;
constexpr int BK32 = 32;
constexpr int THREADS32 = 128;

size_t f32_smem(int hd) {
  return sizeof(float) *
             (static_cast<size_t>(BQ32) * hd + static_cast<size_t>(BK32) *
              (hd + 1) + static_cast<size_t>(BK32) * hd + BQ32 * BK32 +
              static_cast<size_t>(BQ32) * hd + 3 * BQ32) +
         sizeof(int) * (BQ32 + BK32 + 1);
}

__global__ void __launch_bounds__(THREADS32)
flash_prefill_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ q_pos,
                         const int* __restrict__ k_pos,
                         float* __restrict__ out, int S, int T, int H,
                         int KV, int hd, bool causal, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [BQ][hd] pre-scaled
  float* ks = qs + BQ32 * hd;              // [BK][hd + 1]
  float* vs = ks + BK32 * (hd + 1);        // [BK][hd]
  float* p = vs + BK32 * hd;               // [BQ][BK]
  float* acc = p + BQ32 * BK32;            // [BQ][hd]
  float* m = acc + BQ32 * hd;              // [BQ]
  float* l = m + BQ32;
  float* alpha = l + BQ32;
  int* qps = reinterpret_cast<int*>(alpha + BQ32);
  int* kps = qps + BQ32;
  int* qmax_s = kps + BK32;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int ks_stride = hd + 1;

  for (int i = tid; i < BQ32 * hd; i += THREADS32) {
    const int r = i / hd, d = i - r * hd;
    qs[i] = q0 + r < S
                ? q[((static_cast<size_t>(b) * S + q0 + r) * H + h) * hd + d] *
                      scale
                : 0.f;
    acc[i] = 0.f;
  }
  if (tid < BQ32) {
    qps[tid] = q0 + tid < S ? q_pos[static_cast<size_t>(b) * S + q0 + tid]
                            : INT_MIN;
    m[tid] = NEG;
    l[tid] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int mx = INT_MIN;
    for (int r = 0; r < BQ32; ++r) mx = max(mx, qps[r]);
    *qmax_s = mx;
  }
  __syncthreads();
  const int qmax = *qmax_s;

  for (int k0 = 0; k0 < T; k0 += BK32) {
    int kp = -1;
    if (tid < BK32) {
      kp = k0 + tid < T ? k_pos[static_cast<size_t>(b) * T + k0 + tid] : -1;
      kps[tid] = kp;
    }
    if (!__syncthreads_or(tid < BK32 && key_valid(kp, qmax, causal)))
      continue;

    for (int i = tid; i < BK32 * hd; i += THREADS32) {
      const int r = i / hd, d = i - r * hd;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < T) {
        const size_t at =
            ((static_cast<size_t>(b) * T + k0 + r) * KV + kvh) * hd + d;
        kx = k[at];
        vx = v[at];
      }
      ks[r * ks_stride + d] = kx;
      vs[i] = vx;
    }
    __syncthreads();

    // scores: one (row, key) pair per thread; a warp is one row
    for (int i = tid; i < BQ32 * BK32; i += THREADS32) {
      const int r = i / BK32, t = i - r * BK32;
      float s = NEG;
      if (key_valid(kps[t], qps[r], causal)) {
        s = 0.f;
        for (int d = 0; d < hd; ++d) s += qs[r * hd + d] * ks[t * ks_stride + d];
      }
      p[i] = s;
    }
    __syncthreads();

    // online softmax, one warp per row, one lane per key
    for (int r = warp; r < BQ32; r += THREADS32 / 32) {
      const bool ok = key_valid(kps[lane], qps[r], causal);
      const float sv = p[r * BK32 + lane];
      float mx = sv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
      const float e = ok ? expf(sv - m_new) : 0.f;
      float sum = e;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p[r * BK32 + lane] = e;
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        l[r] = l[r] * a + sum;
        m[r] = m_new;
        alpha[r] = a;
      }
    }
    __syncthreads();

    for (int i = tid; i < BQ32 * hd; i += THREADS32) {
      const int r = i / hd, d = i - r * hd;
      float a = acc[i] * alpha[r];
      for (int t = 0; t < BK32; ++t) a += p[r * BK32 + t] * vs[t * hd + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < BQ32 * hd; i += THREADS32) {
    const int r = i / hd, d = i - r * hd;
    if (q0 + r < S)
      out[((static_cast<size_t>(b) * S + q0 + r) * H + h) * hd + d] =
          acc[i] / fmaxf(l[r], 1e-30f);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

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

// A 4-D bf16 map over (hd, heads, seq, batch) of a contiguous
// (batch, seq, heads, hd) tensor, boxes of `rows` x `box` columns.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int hd,
                  int heads, int seq, int batch, int box, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t boxes[4] = {static_cast<cuuint32_t>(box), 1,
                               static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, boxes, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             2 * box == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);     // zeros out of bounds
}

// Returns a CUDA error code, or -(CUresult) if the CUDA driver refused a
// tensor map.
template <int HD>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* q_pos, const void* k_pos, void* out, int B, int S,
                int T, int H, int KV, bool causal, float scale,
                cudaStream_t stream) {
  using L = Layout<HD>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(enc, &tq, q, HD, H, S, B, L::BOX, BQ);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tk, k, HD, KV, T, B, L::BOX, BK);
  if (r == CUDA_SUCCESS) r = make_map(enc, &tv, v, HD, KV, T, B, L::BOX, BK);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const size_t smem = L::smem();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_bf16_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long tiles = static_cast<long>((S + BQ - 1) / BQ) * B * H;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  const float log2e = 1.4426950408889634f;
  flash_prefill_bf16_kernel<HD><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<float*>(out), B, S, T, H,
      KV, causal ? 1 : 0, scale * log2e);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, const void* q_pos,
               const void* k_pos, void* out, int B, int S, int T, int H,
               int KV, int hd, bool causal, float scale,
               cudaStream_t stream) {
  const size_t smem = f32_smem(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ32 - 1) / BQ32, H, B);
  flash_prefill_f32_kernel<<<grid, THREADS32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<float*>(out), S, T, H, KV,
      hd, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bf16 (hd 32, 64 or 128, scale > 0), 1 = fp32 (hd <= 256).
// Returns a CUDA error code; negative: the CUDA driver refused a TMA tensor
// map.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* q_pos, const void* k_pos, void* out,
                             int B, int S, int T, int H, int KV, int hd,
                             int causal, float scale, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool c = causal != 0;
  if (dtype == 1) {
    if (hd <= 0 || hd > 256) return static_cast<int>(cudaErrorInvalidValue);
    return launch_f32(q, k, v, q_pos, k_pos, out, B, S, T, H, KV, hd, c,
                      scale, s);
  }
  if (dtype != 0 || !(scale > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch_bf16<32>(q, k, v, q_pos, k_pos, out, B, S, T, H, KV, c,
                             scale, s);
    case 64:
      return launch_bf16<64>(q, k, v, q_pos, k_pos, out, B, S, T, H, KV, c,
                             scale, s);
    case 128:
      return launch_bf16<128>(q, k, v, q_pos, k_pos, out, B, S, T, H, KV, c,
                              scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
