// LogFMT-nBit decode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/logfmt/logfmt.py:logfmt_decode
// (body _decode_kernel). Per 1x128 tile of codes (N, D), D % 128 == 0, with
// the tile's fp32 sideband mn and step:
//   k = code & (2^(n-1) - 1), sign = bit n-1,
//   y = 0 for k = 0, else (sign ? -1 : 1) * exp(mn + step*(k-1)),
// written as fp32 or bf16 (round to nearest even).
//
// The arithmetic is the plain version's (core/logfmt.py): expf (no fast
// math) of __fadd_rn(mn, __fmul_rn(step, k-1)), so that nvcc does not
// contract it into an FMA the plain version does not do.
//
// One warp per tile, 8 tiles per block of 256 threads; lane l decodes codes
// 4l..4l+3 from one 32-bit (uint8) or 64-bit (uint16) load, reads the
// tile's mn and step once (one broadcast load per warp) and writes its 4
// values in one 16-byte (fp32) or 8-byte (bf16) store. The grid covers the
// N*D/128 tiles exactly: no padding.
//
// Bound on an H100: the bytes, read the codes and sideband once and write
// y once (167 MB for a (1792, 18432) chunk at 8 bits to fp32: 0.050 ms at
// 3.35 TB/s); one expf per value on the CUDA cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 128;
constexpr int THREADS = 256;
constexpr int TILES_PER_BLOCK = THREADS / 32;

template <typename C>
struct Codes;

template <>
struct Codes<uint8_t> {
  __device__ static void load(const uint8_t* p, unsigned c[4]) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
    c[0] = w & 0xffu;
    c[1] = (w >> 8) & 0xffu;
    c[2] = (w >> 16) & 0xffu;
    c[3] = w >> 24;
  }
};

template <>
struct Codes<uint16_t> {
  __device__ static void load(const uint16_t* p, unsigned c[4]) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    c[0] = w.x & 0xffffu;
    c[1] = w.x >> 16;
    c[2] = w.y & 0xffffu;
    c[3] = w.y >> 16;
  }
};

template <typename O>
struct Out;

template <>
struct Out<float> {
  __device__ static void store(float* p, const float y[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  }
};

template <>
struct Out<__nv_bfloat16> {
  __device__ static void store(__nv_bfloat16* p, const float y[4]) {
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(y[0], y[1]);
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(y[2], y[3]);
    uint2 w;
    w.x = *reinterpret_cast<const unsigned*>(&h0);
    w.y = *reinterpret_cast<const unsigned*>(&h1);
    *reinterpret_cast<uint2*>(p) = w;
  }
};

template <typename C, typename O>
__global__ void __launch_bounds__(THREADS)
logfmt_decode_kernel(const C* __restrict__ codes,
                     const float* __restrict__ mn_in,
                     const float* __restrict__ step_in, O* __restrict__ out,
                     long long tiles, int n_bits) {
  const int lane = threadIdx.x & 31;
  const long long tile =
      static_cast<long long>(blockIdx.x) * TILES_PER_BLOCK + (threadIdx.x >> 5);
  if (tile >= tiles) return;
  const size_t base = static_cast<size_t>(tile) * TILE + lane * 4;

  unsigned c[4];
  Codes<C>::load(codes + base, c);
  const float mn = __ldg(mn_in + tile);
  const float step = __ldg(step_in + tile);
  const unsigned sign_mask = 1u << (n_bits - 1);
  float y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned k = c[i] & (sign_mask - 1u);
    const float e = __fadd_rn(mn, __fmul_rn(step, static_cast<float>(k) - 1.f));
    const float mag = expf(e);
    y[i] = k == 0u ? 0.f : ((c[i] & sign_mask) ? -mag : mag);
  }
  Out<O>::store(out + base, y);
}

template <typename C, typename O>
int launch(const void* codes, const void* mn, const void* step, void* out,
           long long tiles, int n_bits, cudaStream_t stream) {
  const long long blocks = (tiles + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK;
  logfmt_decode_kernel<C, O><<<static_cast<unsigned>(blocks), THREADS, 0,
                               stream>>>(
      static_cast<const C*>(codes), static_cast<const float*>(mn),
      static_cast<const float*>(step), static_cast<O*>(out), tiles, n_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// codes are uint8 for n_bits <= 8, else uint16; out: 0 = fp32, 1 = bf16
extern "C" int logfmt_decode(const void* codes, const void* mn,
                             const void* step, void* out, long long tiles,
                             int n_bits, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bits < 2 || n_bits > 16 || tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bytes = n_bits <= 8;
  switch (out_dtype) {
    case 0:
      return bytes ? launch<uint8_t, float>(codes, mn, step, out, tiles,
                                            n_bits, s)
                   : launch<uint16_t, float>(codes, mn, step, out, tiles,
                                             n_bits, s);
    case 1:
      return bytes ? launch<uint8_t, __nv_bfloat16>(codes, mn, step, out,
                                                    tiles, n_bits, s)
                   : launch<uint16_t, __nv_bfloat16>(codes, mn, step, out,
                                                     tiles, n_bits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
