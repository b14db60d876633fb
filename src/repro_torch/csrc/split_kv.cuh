// Split-KV decode, the parts that paged_gqa_decode.cu and
// paged_mla_decode.cu share: asynchronous global -> shared copies, warp
// reductions, E4M3 pairs to fp32, and the combine pass.
//
// A split kernel runs one CTA per (slot, heads, split of rps rows) and
// writes, for each of its heads, the split's softmax state in fp32:
//   m = max_t s_t,  l = sum_t exp(s_t - m),  acc = sum_t exp(s_t - m) v_t
// over the split's rows t <= qpos, into a workspace laid out as
//   m, l: (B, H, S),  acc: (B, H, S, D).
// A paged split that starts past its slot's qpos writes nothing. The
// combine pass then reads qpos on the card to know how many splits a slot
// has:
//   n_tok = min(qpos + 1, rows),  ns = ceil(n_tok / rps),
//   M = max_s m_s,  w_s = exp(m_s - M),
//   o = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30).
// A ring's valid rows may sit in any split, so in ring mode (RING) every
// split writes m and l (NEG and 0 when it holds no valid row), all S
// splits are considered, and a split with l = 0 gets w_s = 0 and its
// accumulator, which it never wrote, is not read. A slot with no valid row
// comes out zero.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace splitkv {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// two E4M3 codes (low byte first) -> fp32, exactly (E4M3 is a subset of
// fp16)
__device__ __forceinline__ float2 e4m3x2(uint32_t pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xffffu), __NV_E4M3);
  return __half22float2(__half2(h));
}

// Four values of a pool type T as one word (E4M3: 4 bytes, bf16: 8,
// fp32: 16), widened to fp32 and multiplied by the row's scale
template <typename T>
struct Four;
template <>
struct Four<uint8_t> {
  using W = uint32_t;
  __device__ static float4 widen(W u, float sc) {
    const float2 a = e4m3x2(u), c = e4m3x2(u >> 16);
    return make_float4(a.x * sc, a.y * sc, c.x * sc, c.y * sc);
  }
};
template <>
struct Four<__nv_bfloat16> {
  using W = uint2;
  __device__ static float4 widen(W u, float sc) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x * sc, a.y * sc, c.x * sc, c.y * sc);
  }
};
template <>
struct Four<float> {
  using W = float4;
  __device__ static float4 widen(W u, float sc) {
    return make_float4(u.x * sc, u.y * sc, u.z * sc, u.w * sc);
  }
};

// word j of a 16-byte vector (j a constant after unrolling: no address
// taken, so the vector stays in registers)
template <typename T>
__device__ __forceinline__ typename Four<T>::W word(const uint4& x, int j);
template <>
__device__ __forceinline__ uint32_t word<uint8_t>(const uint4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}
template <>
__device__ __forceinline__ uint2 word<__nv_bfloat16>(const uint4& x, int j) {
  return j == 0 ? make_uint2(x.x, x.y) : make_uint2(x.z, x.w);
}
template <>
__device__ __forceinline__ float4 word<float>(const uint4& x, int) {
  return make_float4(__uint_as_float(x.x), __uint_as_float(x.y),
                     __uint_as_float(x.z), __uint_as_float(x.w));
}

// four values at p (shared memory, aligned to the word)
template <typename T>
__device__ __forceinline__ float4 load4(const unsigned char* p, float sc) {
  return Four<T>::widen(*reinterpret_cast<const typename Four<T>::W*>(p),
                        sc);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// LDGSTS: an asynchronous copy of `bytes` (16, 8 or 4; 16 bypasses L1)
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const uint32_t d = smem_addr(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows of a slot that the kernels read: min(qpos + 1, rows)
__device__ __forceinline__ int slot_tokens(const int* qpos, int b, int rows) {
  return min(qpos[b] + 1, rows);
}

// The combine pass: one block per (head h, slot b) = (blockIdx.x,
// blockIdx.y), threads over the D output columns four at a time (D % 4 ==
// 0); S floats of dynamic shared memory hold the split weights. Each thread
// keeps four splits' loads in flight. In ring mode qpos, rows and rps are
// not read.
constexpr int COMBINE_THREADS = 128;

template <bool RING = false>
__device__ __forceinline__ void combine(const float* __restrict__ pm,
                                        const float* __restrict__ pl,
                                        const float* __restrict__ pacc,
                                        const int* __restrict__ qpos,
                                        float* __restrict__ out, int H,
                                        int S, int D, int rows, int rps) {
  extern __shared__ float w[];      // [S]
  __shared__ float denom;
  const int h = blockIdx.x, b = blockIdx.y;
  int ns = S;
  if (!RING) {
    const int n_tok = slot_tokens(qpos, b, rows);
    ns = n_tok > 0 ? (n_tok + rps - 1) / rps : 0;
  }
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float* m = pm + bh * S;
  const float* l = pl + bh * S;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float M = NEG;
    for (int s = lane; s < ns; s += 32) M = fmaxf(M, m[s]);
    M = warp_max(M);
    float L = 0.f;
    for (int s = lane; s < ns; s += 32) {
      const float ws = (RING && !(l[s] > 0.f)) ? 0.f : expf(m[s] - M);
      w[s] = ws;
      L += ws * l[s];
    }
    L = warp_sum(L);
    if (lane == 0) denom = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const int D4 = D / 4;
  const float4* acc = reinterpret_cast<const float4*>(pacc + bh * S * D);
  float4* o4 = reinterpret_cast<float4*>(out + bh * D);
  for (int d = threadIdx.x; d < D4; d += blockDim.x) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    int s = 0;
    for (; s + 4 <= ns; s += 4) {
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        x[u] = (!RING || w[s + u] != 0.f)
                   ? acc[static_cast<size_t>(s + u) * D4 + d]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float ws = w[s + u];
        o.x += ws * x[u].x;
        o.y += ws * x[u].y;
        o.z += ws * x[u].z;
        o.w += ws * x[u].w;
      }
    }
    for (; s < ns; ++s) {
      const float ws = w[s];
      if (RING && ws == 0.f) continue;
      const float4 x = acc[static_cast<size_t>(s) * D4 + d];
      o.x += ws * x.x;
      o.y += ws * x.y;
      o.z += ws * x.z;
      o.w += ws * x.w;
    }
    o4[d] = make_float4(o.x / denom, o.y / denom, o.z / denom, o.w / denom);
  }
}

// threads of a combine block for D output columns: a thread per four,
// whole warps, at most COMBINE_THREADS
inline int combine_threads(int D) {
  const int warps = (D / 4 + 31) / 32;
  return warps * 32 < COMBINE_THREADS ? warps * 32 : COMBINE_THREADS;
}

}  // namespace splitkv
