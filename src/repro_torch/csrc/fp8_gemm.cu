// Fine-grained-scaled FP8 GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fp8_gemm/fp8_gemm.py:fp8_gemm.
//   y (M,N) fp32 = (xq * xs) @ (wq * ws)
//   xq (M,K) E4M3 bytes, xs (M, K/128) fp32   -- 1x128 activation tiles
//   wq (K,N) E4M3 bytes, ws (K/128, N/128) fp32 -- 128x128 weight blocks
// Requires M % 16 == 0, K % 128 == 0, N % 128 == 0 (the wrapper pads).
//
// One block of four warps computes a 16x128 output tile. For each K group
// of 128 it stages the E4M3 tiles in shared memory, converts them exactly
// to fp16 (every E4M3 value is an fp16 value) while building the mma.sync
// fragments, accumulates the group's product into a fresh fp32 partial,
// then adds partial * xs[m,k] * ws[k,n] into the fp32 accumulator: the
// scales are constant within the group, so they apply to the partial (the
// paper's §3.1 per-group promotion; fp16 x fp16 products are exact in
// fp32).
//
// Bound on an H100: weight bytes at decode (M = slots), tensor-core rate at
// prefill. This version stages one group at a time without overlapping the
// next group's loads (no cp.async/TMA pipeline) and uses mma.sync, not FP8
// wgmma: it is the simple, checked version; the fast one is later work.
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int BM = 16;
constexpr int BN = 128;
constexpr int BK = 128;        // = the scale group
constexpr int THREADS = 128;   // 4 warps, 32 output columns each
constexpr int PAD = 16;        // keeps rows 16-byte aligned

// Two E4M3 bytes (lo = lower index) -> two fp16 in one register.
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint16_t v) {
  __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(v), __NV_E4M3);
  return pack16(h.x, h.y);
}

__global__ void __launch_bounds__(THREADS)
fp8_gemm_kernel(const uint8_t* __restrict__ xq, const float* __restrict__ xs,
                const uint8_t* __restrict__ wq, const float* __restrict__ ws,
                float* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) uint8_t As[BM][BK + PAD];
  __shared__ __align__(16) uint8_t Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KB = K / BK, NB = N / BN;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  for (int kb = 0; kb < KB; ++kb) {
    // A tile: 16 rows x 128 bytes = 128 threads x 16 bytes
    {
      const int r = tid >> 3, c = (tid & 7) * 16;
      *reinterpret_cast<uint4*>(&As[r][c]) = *reinterpret_cast<const uint4*>(
          xq + static_cast<size_t>(m0 + r) * K + kb * BK + c);
    }
    // B tile: 128 rows x 128 bytes = 8 x (128 threads x 16 bytes)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx >> 3, c = (idx & 7) * 16;
      *reinterpret_cast<uint4*>(&Bs[r][c]) = *reinterpret_cast<const uint4*>(
          wq + static_cast<size_t>(kb * BK + r) * N + n0 + c);
    }
    __syncthreads();

    float part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[j][r] = 0.f;

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4];
      a[0] = e4m3x2_to_f16x2(*reinterpret_cast<const uint16_t*>(&As[g][kk + 2 * t]));
      a[1] = e4m3x2_to_f16x2(*reinterpret_cast<const uint16_t*>(&As[g + 8][kk + 2 * t]));
      a[2] = e4m3x2_to_f16x2(*reinterpret_cast<const uint16_t*>(&As[g][kk + 2 * t + 8]));
      a[3] = e4m3x2_to_f16x2(*reinterpret_cast<const uint16_t*>(&As[g + 8][kk + 2 * t + 8]));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = warp * 32 + j * 8 + g;
        const uint16_t b0 = static_cast<uint16_t>(Bs[kk + 2 * t][n]) |
                            (static_cast<uint16_t>(Bs[kk + 2 * t + 1][n]) << 8);
        const uint16_t b1 = static_cast<uint16_t>(Bs[kk + 2 * t + 8][n]) |
                            (static_cast<uint16_t>(Bs[kk + 2 * t + 9][n]) << 8);
        const uint32_t b[2] = {e4m3x2_to_f16x2(b0), e4m3x2_to_f16x2(b1)};
        mma_f16_16816(part[j], a, b);
      }
    }

    // the group's scales: one per row (xs) times one per 128-column block
    // (ws; this block's 128 columns are one weight block)
    const float wsv = ws[kb * NB + blockIdx.x];
    const float s0 = xs[static_cast<size_t>(m0 + g) * KB + kb] * wsv;
    const float s1 = xs[static_cast<size_t>(m0 + g + 8) * KB + kb] * wsv;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j][0] += part[j][0] * s0;
      acc[j][1] += part[j][1] * s0;
      acc[j][2] += part[j][2] * s1;
      acc[j][3] += part[j][3] * s1;
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + warp * 32 + j * 8 + 2 * t;
    float* r0 = y + static_cast<size_t>(m0 + g) * N + n;
    float* r1 = y + static_cast<size_t>(m0 + g + 8) * N + n;
    r0[0] = acc[j][0];
    r0[1] = acc[j][1];
    r1[0] = acc[j][2];
    r1[1] = acc[j][3];
  }
}

}  // namespace

extern "C" int fp8_gemm(const void* xq, const void* xs, const void* wq,
                        const void* ws, void* y, int M, int N, int K,
                        void* stream) {
  dim3 grid(N / BN, M / BM);
  fp8_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(wq), static_cast<const float*>(ws),
      static_cast<float*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
