// Grouped expert GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm/moe_gemm.py:moe_gemm.
//   y[e] = x[e] @ w[e]   x (E,C,D) bf16, w (E,D,F) bf16 -> y (E,C,F) bf16,
//                        fp32 accumulation
// Requires C % 16 == 0, D % 32 == 0, F % 128 == 0 (the wrapper pads).
//
// One block of four warps per (128-wide F tile, 16-row C tile, expert)
// loops over D in 32-deep steps: both tiles go to shared memory, then each
// warp runs mma.sync m16n8k16 on bf16 with fp32 accumulation for its 32
// output columns. bf16 x bf16 products are exact in fp32, so this matches
// the TPU kernel's fp32 upcast up to the order of the sums; the fp32 sum
// rounds to bf16 once, at the store (round to nearest even).
//
// Bound on an H100: at decode C = 8 (padded to 16), so each call streams
// the whole E*D*F weight once at ~16 flops/byte -- bytes over 3.35 TB/s.
// Each weight element is read by exactly one block; the loads are not yet
// overlapped with the math (no cp.async/TMA pipeline).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int BM = 16;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int PAD = 8;         // rows stay 16-byte aligned

__global__ void __launch_bounds__(THREADS)
moe_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ y, int C, int D, int F) {
  __shared__ __align__(16) uint16_t As[BM][BK + PAD];
  __shared__ __align__(16) uint16_t Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const size_t e = blockIdx.z;
  const uint16_t* xe = reinterpret_cast<const uint16_t*>(x) + e * C * D;
  const uint16_t* we = reinterpret_cast<const uint16_t*>(w) + e * D * F;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    // A tile: 16 x 32 bf16 = 64 threads x 8 values (16 bytes)
    if (tid < 64) {
      const int r = tid >> 2, c = (tid & 3) * 8;
      *reinterpret_cast<uint4*>(&As[r][c]) = *reinterpret_cast<const uint4*>(
          xe + static_cast<size_t>(m0 + r) * D + k0 + c);
    }
    // B tile: 32 x 128 bf16 = 4 x (128 threads x 8 values)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx >> 4, c = (idx & 15) * 8;
      *reinterpret_cast<uint4*>(&Bs[r][c]) = *reinterpret_cast<const uint4*>(
          we + static_cast<size_t>(k0 + r) * F + n0 + c);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(&As[g][kk + 2 * t]);
      a[1] = *reinterpret_cast<const uint32_t*>(&As[g + 8][kk + 2 * t]);
      a[2] = *reinterpret_cast<const uint32_t*>(&As[g][kk + 2 * t + 8]);
      a[3] = *reinterpret_cast<const uint32_t*>(&As[g + 8][kk + 2 * t + 8]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = warp * 32 + j * 8 + g;
        const uint32_t b[2] = {
            pack16(Bs[kk + 2 * t][n], Bs[kk + 2 * t + 1][n]),
            pack16(Bs[kk + 2 * t + 8][n], Bs[kk + 2 * t + 9][n])};
        mma_bf16_16816(acc[j], a, b);
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* ye = y + e * C * F;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + warp * 32 + j * 8 + 2 * t;
    __nv_bfloat162 v0 = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    __nv_bfloat162 v1 = __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    *reinterpret_cast<__nv_bfloat162*>(
        ye + static_cast<size_t>(m0 + g) * F + n) = v0;
    *reinterpret_cast<__nv_bfloat162*>(
        ye + static_cast<size_t>(m0 + g + 8) * F + n) = v1;
  }
}

}  // namespace

extern "C" int moe_gemm(const void* x, const void* w, void* y, int E, int C,
                        int D, int F, void* stream) {
  dim3 grid(F / BN, C / BM, E);
  moe_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), C, D, F);
  return static_cast<int>(cudaGetLastError());
}
