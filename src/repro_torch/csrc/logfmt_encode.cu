// LogFMT-nBit encode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/logfmt/logfmt.py:logfmt_encode
// (body _encode_kernel). Per 1x128 tile of x (N, D), D % 128 == 0:
//   mx = max log|x|, mn = min log|x| over the nonzeros (0 for a tile of
//   zeros), mn = max(mn, mx - 32 ln 2), step = max((mx-mn)/(levels-1), 1e-12),
//   levels = 2^(n-1) - 1; each value gets the nearer, in linear space, of
//   the two grid points exp(mn + step*k) that bracket it, and the code
//   (sign << (n-1)) | (k+1), 0 for an exact zero.
// Outputs: codes (N, D) uint8 (n <= 8) or uint16 (9..16 bits), mn and step
// (N, D/128) fp32.
//
// The arithmetic is the plain version's (core/logfmt.py), operation by
// operation in fp32: logf/expf (not __logf/__expf; the build has no
// --use_fast_math), IEEE division for the step and for (log|x| - mn)/step,
// and mn + step*k as __fadd_rn(mn, __fmul_rn(step, k)) so that nvcc does
// not contract it into an FMA the plain version does not do. The codes then
// agree with the plain version's except where a last-ulp difference of
// logf/expf flips a tie between two levels.
//
// One warp per tile, 8 tiles per block of 256 threads; lane l holds values
// 4l..4l+3 (one 16-byte load for fp32, 8 bytes for bf16), the tile's min
// and max of the logs come from warp shuffles, and each lane stores its 4
// codes in one 32-bit (uint8) or 64-bit (uint16) store; lane 0 writes the
// sideband. The grid covers the N*D/128 tiles exactly: no padding.
//
// Bound on an H100: the bytes, read x once and write the codes and the
// sideband once (167 MB for a (1792, 18432) fp32 chunk at 8 bits: 0.050 ms
// at 3.35 TB/s). Each value also costs a logf, two expf and a division on
// the CUDA cores, which is what the kernel spends beyond the bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int TILE = 128;
constexpr int THREADS = 256;
constexpr int TILES_PER_BLOCK = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// 32 ln 2 as the reference's fp32 arithmetic holds it
constexpr float RANGE_CLAMP = 22.180709838867188f;

template <typename T>
struct In;

template <>
struct In<float> {
  __device__ static void load(const float* p, float v[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct In<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float v[4]) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
    const float2 f0 = __bfloat1622float2(h[0]);
    const float2 f1 = __bfloat1622float2(h[1]);
    v[0] = f0.x;
    v[1] = f0.y;
    v[2] = f1.x;
    v[3] = f1.y;
  }
};

template <typename C>
struct Codes;

template <>
struct Codes<uint8_t> {
  __device__ static void store(uint8_t* p, const unsigned c[4]) {
    *reinterpret_cast<unsigned*>(p) =
        c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24);
  }
};

template <>
struct Codes<uint16_t> {
  __device__ static void store(uint16_t* p, const unsigned c[4]) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(c[0] | (c[1] << 16), c[2] | (c[3] << 16));
  }
};

template <typename T, typename C>
__global__ void __launch_bounds__(THREADS)
logfmt_encode_kernel(const T* __restrict__ x, C* __restrict__ codes,
                     float* __restrict__ mn_out, float* __restrict__ step_out,
                     long long tiles, int n_bits) {
  const int lane = threadIdx.x & 31;
  const long long tile =
      static_cast<long long>(blockIdx.x) * TILES_PER_BLOCK + (threadIdx.x >> 5);
  if (tile >= tiles) return;               // the whole warp leaves together
  const size_t base = static_cast<size_t>(tile) * TILE + lane * 4;

  float v[4];
  In<T>::load(x + base, v);
  float a[4], la[4];
  float lmin = INFINITY, lmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = fabsf(v[i]);
    la[i] = INFINITY;                      // exact zero: no log
    if (a[i] > 0.f) {
      la[i] = logf(a[i]);
      lmin = fminf(lmin, la[i]);
      lmax = fmaxf(lmax, la[i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lmin = fminf(lmin, __shfl_xor_sync(FULL, lmin, o));
    lmax = fmaxf(lmax, __shfl_xor_sync(FULL, lmax, o));
  }
  const int levels = (1 << (n_bits - 1)) - 1;
  const float top = static_cast<float>(levels - 1);
  const float mx = isfinite(lmax) ? lmax : 0.f;
  float mn = isfinite(lmin) ? lmin : 0.f;
  mn = fmaxf(mn, mx - RANGE_CLAMP);
  const float step =
      fmaxf((mx - mn) / static_cast<float>(max(levels - 1, 1)), 1e-12f);

  unsigned c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float tt = fminf(fmaxf((la[i] - mn) / step, 0.f), top);
    const float k0 = floorf(tt);
    const float k1 = fminf(k0 + 1.f, top);
    const float lo = expf(__fadd_rn(mn, __fmul_rn(step, k0)));
    const float hi = expf(__fadd_rn(mn, __fmul_rn(step, k1)));
    const float k = (a[i] - lo) > (hi - a[i]) ? k1 : k0;
    const unsigned code = a[i] > 0.f ? static_cast<unsigned>(k + 1.f) : 0u;
    const unsigned sign = v[i] < 0.f ? 1u : 0u;
    c[i] = (sign << (n_bits - 1)) | code;
  }
  Codes<C>::store(codes + base, c);
  if (lane == 0) {
    mn_out[tile] = mn;
    step_out[tile] = step;
  }
}

template <typename T, typename C>
int launch(const void* x, void* codes, void* mn, void* step, long long tiles,
           int n_bits, cudaStream_t stream) {
  const long long blocks = (tiles + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK;
  logfmt_encode_kernel<T, C><<<static_cast<unsigned>(blocks), THREADS, 0,
                               stream>>>(
      static_cast<const T*>(x), static_cast<C*>(codes),
      static_cast<float*>(mn), static_cast<float*>(step), tiles, n_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: 0 = fp32, 1 = bf16; codes are uint8 for n_bits <= 8, else uint16
extern "C" int logfmt_encode(const void* x, void* codes, void* mn,
                             void* step, long long tiles, int n_bits,
                             int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bits < 2 || n_bits > 16 || tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bytes = n_bits <= 8;
  switch (x_dtype) {
    case 0:
      return bytes ? launch<float, uint8_t>(x, codes, mn, step, tiles,
                                            n_bits, s)
                   : launch<float, uint16_t>(x, codes, mn, step, tiles,
                                             n_bits, s);
    case 1:
      return bytes ? launch<__nv_bfloat16, uint8_t>(x, codes, mn, step,
                                                    tiles, n_bits, s)
                   : launch<__nv_bfloat16, uint16_t>(x, codes, mn, step,
                                                     tiles, n_bits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
