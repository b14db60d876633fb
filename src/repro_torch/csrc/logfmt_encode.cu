// LogFMT-nBit encode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/logfmt/logfmt.py:logfmt_encode
// (body _encode_kernel). Per 1x128 tile of x (N, D), D % 128 == 0:
//   mx = max log|x|, mn = min log|x| over the nonzeros (0 for a tile of
//   zeros), mn = max(mn, mx - 32 ln 2), step = max((mx-mn)/(levels-1), 1e-12),
//   levels = 2^(n-1) - 1; each value gets the nearer, in linear space, of
//   the two grid points g(k) = exp(mn + step*k) that bracket it, and the
//   code (sign << (n-1)) | (k+1); 0 for a zero. The reference's platforms
//   compute without subnormals (denormals are zero on XLA's CPU, the TPU
//   flushes them), so a subnormal input (|x| < 2^-126) counts as zero (code
//   0, no sign bit, outside the range), as NaN does, and a grid point or a
//   difference below 2^-126 is zero.
// Outputs: codes (N, D) uint8 (n <= 8) or uint16 (9..16 bits), mn and step
// (N, D/128) fp32.
//
// Bound on an H100: the bytes, x read once and the codes and sideband
// written once (167.2 MB for a (1792, 18432) fp32 chunk at 8 bits, 0.0499
// ms at 3.35 TB/s; 200.2 MB, 0.0598 ms at 10 bits). The first version spent
// a precise logf, an IEEE division and two expf on every value, one warp a
// tile, and took 0.130 ms at either width, bound by instruction issue. This
// one moves the transcendentals from the values to the tile:
//
// * The range from two logs a tile. Positive floats order like their bits,
//   so the min and max of |x| over the nonzeros (bits in [0x00800000,
//   0x7f800000]: normals and inf; NaN and subnormals fall outside) are two
//   integer reductions over the warp (REDUX), and mn, mx are the logf of
//   those two values: the reference's min and max of the logs wherever logf
//   is non-decreasing, which logfmt_logf_sweep checks over every positive
//   normal float (a card test). log(inf) is not finite, so mx = 0 then, as
//   in the reference.
// * Several tiles a warp. A warp loads TILES_PER_WARP consecutive tiles at
//   once (lane l holds values 4l..4l+3 of each: one 16-byte load for fp32,
//   8 bytes for bf16), and lane j works out tile j's parameters (the two
//   logf, the step, m and E below) and shares them through shared memory:
//   a tile's scalar work costs one lane, not a warp.
// * Each value's level from a cheap estimate. With m the fraction of a step
//   at which two neighbouring grid points' linear midpoint lies
//   (log((1 + e^step) / 2) / step), the reference's level is floor(u),
//   u = (log a - mn) / step + 1 - m, clamped to [0, levels-1]; the kernel
//   takes log a from lg2.approx (one MUFU) and floor(u) from a rounded add.
//   E bounds, in steps, the error of u against the exact value plus how far
//   the reference's own rounding of its grid points and of its comparison
//   moves a boundary: wherever u lies further than E from an integer,
//   floor(u) is the reference's level (on a tile of normal draws E is
//   about 4e-4 at 8 bits and 1.6e-3 at 10).
// * The rest from the reference's own comparison. A value within E of an
//   integer K lies near the boundary between levels K - 1 and K, where the
//   reference's bracket is K - 1 (its t = u - 1 + m lies near K - 1 + m, far
//   from an integer while E < (1 - m) / 4); the kernel computes the grid
//   points g(K-1), g(K) in the reference's arithmetic (expf, and mn + step*k
//   as __fadd_rn(mn, __fmul_rn(step, k)): no FMA) and takes its comparison
//   (a - g(K-1)) > (g(K) - a). A value near a grid point instead, where the
//   reference's bracket from its logf may be one off, gets the same level
//   from either bracket as long as the grid points lie far apart against
//   the ulps that decide it: their errors come to at most 2e-5 in log space
//   for |log a| <= 89, so the path needs step >= 2^-13. It also needs
//   mn >= -76: the reference computes without subnormals, and where the
//   grid's spacing falls below 2^-126 its comparison sees two zeros and
//   keeps its own bracket. A tile with a smaller step (one or two
//   magnitudes, a step at its 1e-12 floor), smaller values or a larger E
//   takes the reference's arithmetic for every value, flushes included.
//   Both choices are warp-uniform: a warp owns its tiles.
// * Codes: one 32-bit (uint8) or 64-bit (uint16) store a lane and tile;
//   lanes 0..TILES_PER_WARP-1 write the sideband.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): 0.070 ms at 8 bits,
// 0.078 at 10 (71% and 77% of the byte bound), where loads and stores
// alone take 0.059 and 0.072. kernels/logfmt/probe.py times each lever.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int TILE = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// 32 ln 2 as the reference's fp32 arithmetic holds it
constexpr float RANGE_CLAMP = 22.180709838867188f;
constexpr float LN2 = 0.693147180559945309f;
// |x| bits of the values that count as nonzero: the normals and inf
constexpr unsigned LEAST_NORMAL = 0x00800000u;
constexpr unsigned INF_BITS = 0x7f800000u;
constexpr float LEAST_NORMAL_F = 1.17549435e-38f;
// the least step and mn at which the estimate's path gives the reference's
// levels (see the header)
constexpr float FAST_MIN_STEP = 1.0f / 8192.0f;
constexpr float FAST_MIN_MN = -76.f;
// the estimate's error bound E, in steps: (EST_ABS + |log a| EST_REL) / step
// for the logs and grid points, EST_ULPS per level for u's own rounding,
// EST_ABS for m (see the header)
constexpr float EST_ABS = 1.0f / 131072.0f;     // 2^-17
constexpr float EST_REL = 1.0f / 524288.0f;     // 2^-19
constexpr float EST_ULPS = 1.0f / 4194304.0f;   // 2^-22
// 1.5 * 2^23: a float in (-2^22, 2^22) plus this, rounded, is an integer
constexpr float MAGIC = 12582912.0f;
// tiles a warp takes at once: the loads in flight, and the lanes that
// work out the tiles' parameters side by side
constexpr int TILES_PER_WARP = 4;

template <typename T>
struct In;

template <>
struct In<float> {
  __device__ static void load(const float* p, float v[4]) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct In<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float v[4]) {
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
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

// |x|'s bits where x counts as nonzero (a normal or inf), else 0
__device__ __forceinline__ unsigned nonzero_bits(float v) {
  const unsigned m = __float_as_uint(v) & 0x7fffffffu;
  return m - LEAST_NORMAL <= INF_BITS - LEAST_NORMAL ? m : 0u;
}

// the reference's grid point k of a tile
__device__ __forceinline__ float grid_point(float mn, float step, int k) {
  return expf(__fadd_rn(mn, __fmul_rn(step, static_cast<float>(k))));
}

// v as the reference's platforms compute it: zero below 2^-126
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < LEAST_NORMAL_F ? 0.f : v;
}

// lg2.approx: one MUFU.LG2 for a normal or inf a (no subnormal fix-up)
__device__ __forceinline__ float lg2_approx(float a) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// what a tile's values need from it: the reference's mn and step, 1/step,
// the estimate u = lg2(a) c1 + c0 (see encode_fast) and its error bound
// as 0.5 - E, and whether the estimate's path may encode the tile
struct Params {
  float mn, step, inv_step, c1, c0, half_minus_e;
  bool fast;
};

// lane j < TILES_PER_WARP: the min and max of log|x| over tile j's
// nonzeros (0 and 0 for a tile of zeros), from the least and greatest
// nonzero |x| (bits order as the positive floats do): two integer
// reductions a tile, and two logf on lane j
__device__ __forceinline__ void tile_ranges(const float (&v)[TILES_PER_WARP][4],
                                            int lane, float& mn, float& mx) {
  unsigned lo_j = 0xffffffffu, hi_j = 0u;
#pragma unroll
  for (int j = 0; j < TILES_PER_WARP; ++j) {
    // less the least normal, zeros and subnormals wrap past the normals
    // and inf (and NaN) in the min; in the max NaN lies above inf
    unsigned lo = 0xffffffffu, hi = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned m = __float_as_uint(v[j][i]) & 0x7fffffffu;
      lo = min(lo, m - LEAST_NORMAL);
      hi = max(hi, m);
    }
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    if (hi > INF_BITS) {                  // warp-uniform: a NaN, left out
      hi = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned m = __float_as_uint(v[j][i]) & 0x7fffffffu;
        hi = max(hi, m <= INF_BITS ? m : 0u);
      }
      hi = __reduce_max_sync(FULL, hi);
    }
    if (lane == j) {
      lo_j = lo;
      hi_j = hi;
    }
  }
  mn = mx = 0.f;
  if (lo_j <= INF_BITS - LEAST_NORMAL) {  // the tile has a nonzero
    mx = logf(__uint_as_float(hi_j));
    mn = logf(__uint_as_float(lo_j + LEAST_NORMAL));
  }
}

// the parameters of a tile from its min and max of the logs
__device__ __forceinline__ Params tile_params(float mn, float mx,
                                              int levels) {
  if (!isfinite(mx)) mx = 0.f;           // log(inf), as in the reference
  if (!isfinite(mn)) mn = 0.f;
  mn = fmaxf(mn, mx - RANGE_CLAMP);
  Params p;
  p.mn = mn;
  p.step = fmaxf((mx - mn) / static_cast<float>(max(levels - 1, 1)), 1e-12f);
  p.inv_step = __frcp_rn(p.step);
  // m: where between two neighbouring grid points, in steps, their linear
  // midpoint lies: log((1 + e^s) / 2) / s = 1/2 + s/8 - s^3/192 + ...
  const float s = p.step;
  const float m = s < 0.125f ? 0.5f + s * (0.125f - s * s * (1.f / 192.f))
                             : 1.f - (LN2 - log1pf(expf(-s))) / s;
  // u = (log a - mn) / step + 1 - m = lg2(a) c1 + c0
  p.c1 = LN2 * p.inv_step;
  p.c0 = (1.f - m) - mn * p.inv_step;
  // E: |u - exact| and how far the reference's own rounding of its grid
  // points and of its comparison moves a boundary, in steps (see the
  // header)
  const float big = fmaxf(fabsf(mn), fabsf(mx)) + s;
  const float e = (EST_ABS + big * EST_REL) * p.inv_step +
                  static_cast<float>(levels + 1) * EST_ULPS + EST_ABS;
  p.half_minus_e = 0.5f - e;
  // and an unsure value's bracket known: t = u - 1 + m within 2E of
  // K - 1 + m, m in [1/2, 1)
  p.fast = s >= FAST_MIN_STEP && mn >= FAST_MIN_MN && e < 0.25f * (1.f - m);
  return p;
}

// the level of a nonzero a in the reference's arithmetic, step by step,
// its grid points and differences flushed below 2^-126
__device__ __noinline__ int level_reference(float a, float mn, float step,
                                            int top) {
  const float tt =
      fminf(fmaxf((logf(a) - mn) / step, 0.f), static_cast<float>(top));
  const float k0 = floorf(tt);
  const float k1 = fminf(k0 + 1.f, static_cast<float>(top));
  const float lo = flush(grid_point(mn, step, static_cast<int>(k0)));
  const float hi = flush(grid_point(mn, step, static_cast<int>(k1)));
  return static_cast<int>(flush(a - lo) > flush(hi - a) ? k1 : k0);
}

// u = (log a - mn) / step + 1 - m = lg2(a) c1 + c0 of a value a of a tile
// with the parameters q = (mn, step, 1/step, c1), r = (c0, ...), clamped
// to [-1/2, levels + 1/2]
__device__ __forceinline__ float estimate(float a, const float4 q,
                                          const float4 r, int levels) {
  return fminf(fmaxf(fmaf(lg2_approx(a), q.w, r.x), -0.5f),
               static_cast<float>(levels) + 0.5f);
}

// the codes, sign bit aside, of the lane's 4 values of a tile the
// estimate's path may encode, with the parameters q = (mn, step, 1/step,
// c1), r = (c0, 0.5 - E): level floor(u) wherever u lies more than E from
// an integer K; elsewhere the reference's comparison of its grid points
// K - 1 and K, its own bracket there
__device__ __forceinline__ void encode_fast(const float v[4], const float4 q,
                                            const float4 r, int levels,
                                            unsigned c[4]) {
  unsigned unsure = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = fabsf(v[i]);
    const bool nonzero = a >= LEAST_NORMAL_F;   // NaN fails too
    // u + 1.5 * 2^23 rounded down is floor(u) + 1.5 * 2^23, whose bits
    // count up from MAGIC's
    const float u = estimate(a, q, r, levels);
    const float f = __fadd_rd(u, MAGIC);
    const float d = (u - (f - MAGIC)) - 0.5f;  // u - floor(u) - 1/2
    if (nonzero && !(fabsf(d) <= r.y)) unsure |= 1u << i;
    const int k1 = __float_as_int(f) - (__float_as_int(MAGIC) - 1);
    c[i] = nonzero ? min(max(k1, 1), levels) : 0u;
  }
  if (__any_sync(FULL, unsure)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!(unsure >> i & 1u)) continue;
      // u rounded to the nearest integer K: the boundary between levels
      // K - 1 and K, within the reference's bracket (its t = u - 1 + m
      // lies near K - 1 + m, far from an integer)
      const float a = fabsf(v[i]);
      const int K = __float_as_int(__fadd_rn(estimate(a, q, r, levels),
                                             MAGIC)) -
                    __float_as_int(MAGIC);
      if (K >= 1 && K < levels) {
        const float lo = grid_point(q.x, q.y, K - 1);
        const float hi = grid_point(q.x, q.y, K);
        c[i] = (a - lo) > (hi - a) ? K + 1 : K;
      }
    }
  }
}

// the codes, sign bit aside, of the lane's 4 values of a tile with the
// parameters q = (mn, step, 1/step, c1), r = (c0, 0.5 - E, the path)
__device__ __forceinline__ void encode(const float v[4], const float4 q,
                                       const float4 r, int levels,
                                       unsigned c[4]) {
  if (r.z != 0.f) {                       // warp-uniform: the tile's path
    encode_fast(v, q, r, levels, c);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned b = nonzero_bits(v[i]);
    c[i] = b ? level_reference(__uint_as_float(b), q.x, q.y, levels - 1) + 1u
             : 0u;
  }
}

template <typename T, typename C>
__global__ void __launch_bounds__(THREADS)
logfmt_encode_kernel(const T* __restrict__ x, C* __restrict__ codes,
                     float* __restrict__ mn_out, float* __restrict__ step_out,
                     long long tiles, int n_bits) {
  // per warp, per tile of its group: (mn, step, 1/step, c1), (c0, 0.5 - E,
  // the path)
  __shared__ float4 params[WARPS][TILES_PER_WARP][2];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int levels = (1 << (n_bits - 1)) - 1;
  const unsigned sign_bit = 1u << (n_bits - 1);
  const long long groups = (tiles + TILES_PER_WARP - 1) / TILES_PER_WARP;
  for (long long g = static_cast<long long>(blockIdx.x) * WARPS + warp;
       g < groups; g += static_cast<long long>(gridDim.x) * WARPS) {
    const long long first = g * TILES_PER_WARP;
    const int count = static_cast<int>(
        min(static_cast<long long>(TILES_PER_WARP), tiles - first));
    float v[TILES_PER_WARP][4];
#pragma unroll
    for (int j = 0; j < TILES_PER_WARP; ++j) {
      if (j < count) {
        In<T>::load(x + (first + j) * TILE + lane * 4, v[j]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[j][i] = 0.f;
      }
    }
    // lane j works out tile j's parameters, once a tile, and shares them
    // through shared memory
    float mn_j, mx_j;
    tile_ranges(v, lane, mn_j, mx_j);
    const Params p = tile_params(mn_j, mx_j, levels);
    if (lane < count) {
      params[warp][lane][0] = make_float4(p.mn, p.step, p.inv_step, p.c1);
      params[warp][lane][1] =
          make_float4(p.c0, p.half_minus_e, p.fast ? 1.f : 0.f, 0.f);
      mn_out[first + lane] = p.mn;
      step_out[first + lane] = p.step;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < TILES_PER_WARP; ++j) {
      if (j >= count) break;
      const float4 q = params[warp][j][0];
      const float4 r = params[warp][j][1];
      unsigned c[4];
      encode(v[j], q, r, levels, c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c[i] && v[j][i] < 0.f) c[i] |= sign_bit;
      Codes<C>::store(codes + (first + j) * TILE + lane * 4, c);
    }
    __syncwarp();                         // the next group's parameters
  }
}

template <typename T, typename C>
int launch(const void* x, void* codes, void* mn, void* step, long long tiles,
           int n_bits, cudaStream_t stream) {
  // blocks resident on one SM, found once per instance
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, logfmt_encode_kernel<T, C>, THREADS, 0);
    return n;
  }();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = (tiles + TILES_PER_WARP - 1) / TILES_PER_WARP;
  long long blocks = (groups + WARPS - 1) / WARPS;
  blocks = std::min(blocks, static_cast<long long>(sms) * per_sm);
  logfmt_encode_kernel<T, C><<<static_cast<unsigned>(blocks), THREADS, 0,
                               stream>>>(
      static_cast<const T*>(x), static_cast<C*>(codes),
      static_cast<float*>(mn), static_cast<float*>(step), tiles, n_bits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bits(const void* x, void* codes, void* mn, void* step,
                long long tiles, int n_bits, cudaStream_t s) {
  return n_bits <= 8
             ? launch<T, uint8_t>(x, codes, mn, step, tiles, n_bits, s)
             : launch<T, uint16_t>(x, codes, mn, step, tiles, n_bits, s);
}

// counts the b in [first, last) with logf(float(b + 1)) < logf(float(b))
__global__ void logf_sweep_kernel(unsigned first, unsigned last,
                                  unsigned long long* violations) {
  unsigned long long n = 0;
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long b =
           first + static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
           threadIdx.x;
       b < last; b += stride) {
    const unsigned u = static_cast<unsigned>(b);
    if (logf(__uint_as_float(u + 1u)) < logf(__uint_as_float(u))) ++n;
  }
  if (n) atomicAdd(violations, n);
}

}  // namespace

// x: 0 = fp32, 1 = bf16; codes are uint8 for n_bits <= 8, else uint16
extern "C" int logfmt_encode(const void* x, void* codes, void* mn,
                             void* step, long long tiles, int n_bits,
                             int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bits < 2 || n_bits > 16 || tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (x_dtype) {
    case 0:
      return launch_bits<float>(x, codes, mn, step, tiles, n_bits, s);
    case 1:
      return launch_bits<__nv_bfloat16>(x, codes, mn, step, tiles, n_bits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The check the range's two logs rest on: adds to *violations (a device
// counter) the count of bit patterns b in [first, last) at which logf
// decreases from float(b) to float(b + 1). Over [0x00800000, 0x7f7fffff)
// that is every pair of neighbouring positive normal floats.
extern "C" int logfmt_logf_sweep(unsigned first, unsigned last,
                                 void* violations, void* stream) {
  if (last <= first || last > INF_BITS - 1u)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  logf_sweep_kernel<<<sms * 8, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      first, last, static_cast<unsigned long long*>(violations));
  return static_cast<int>(cudaGetLastError());
}
