// Paged GQA decode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/
// paged_attention.py:paged_gqa_decode_kernel. Per slot b and query head
// h = kv*G + g (the head axis factors as (KV, G)):
//   s_t = (q[b,h]·k_t[kv]) * scale,  t = 0..qpos[b]
//   o[b,h] = sum_t softmax(s)_t * v_t[kv]                  (fp32, (B,H,hd))
// where row t of slot b lives in physical page table[b, t / page] at offset
// t % page, dequantized as value * per-token scale (E4M3 bytes through the
// exact cuda_fp8.h conversion; bf16 or fp32 pools read with null scale
// pointers, which stand for unit scales).
//
// One block of 512 threads per (KV head, slot): the G query heads of the
// group share every K/V row the block loads, which is the point of GQA. The
// block loads its own qpos and table row and loops over the slot's tokens in
// TT-token tiles (the in-block loop replaces the TPU's sequential page
// axis), stopping at the tile that holds qpos: rows above qpos are masked in
// the reference, so the output is the same. Per tile: the tile's physical
// rows and scales are looked up once into shared memory; K and V rows are
// read in 16-byte vectors, a batch of independent loads in flight per
// thread, and dequantized into shared memory (rows padded so the vector
// stores of neighbouring tokens fall in different banks); each warp scores
// (head, token) pairs with a warp-sum over hd; one warp per head folds the
// tile into its online softmax (m, l); the fp32 accumulator acc[G][hd] in
// shared memory is rescaled and summed, each element owned by one thread.
// G is a runtime value (5 for qwen3-14b), so no loop assumes a power of
// two. A row of hd values must fill whole 16-byte vectors (the wrapper
// checks).
//
// Bound on an H100: the bytes of the resident K/V rows (2*hd per KV head per
// token, + 8 B of scales) against ~4*G*hd flops per row on the CUDA cores.
// KV*B blocks (32 for four slots of qwen3-14b) fill a quarter of the 132
// SMs: splitting a slot's pages across blocks (split-KV) with a second pass
// that combines the partial softmaxes is the next step.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TT = 64;         // tokens per tile
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int BATCH = 4;       // 16-byte loads of K (and of V) in flight
constexpr float NEG = -1e30f;

// 16 bytes of a pool row -> fp32 values times the token's scale, stored as
// float4s at o (16-byte aligned)
__device__ __forceinline__ void dequant16(const uint4& x, float s, float* o,
                                          uint8_t) {
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&x);
#pragma unroll
  for (int j = 0; j < 16; j += 4) {
    float f[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      f[u] = __half2float(__half(__nv_cvt_fp8_to_halfraw(b[j + u],
                                                         __NV_E4M3))) * s;
    *reinterpret_cast<float4*>(o + j) = make_float4(f[0], f[1], f[2], f[3]);
  }
}
__device__ __forceinline__ void dequant16(const uint4& x, float s, float* o,
                                          __nv_bfloat16) {
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
  for (int j = 0; j < 8; j += 4)
    *reinterpret_cast<float4*>(o + j) = make_float4(
        __bfloat162float(b[j]) * s, __bfloat162float(b[j + 1]) * s,
        __bfloat162float(b[j + 2]) * s, __bfloat162float(b[j + 3]) * s);
}
__device__ __forceinline__ void dequant16(const uint4& x, float s, float* o,
                                          float) {
  const float* b = reinterpret_cast<const float*>(&x);
  *reinterpret_cast<float4*>(o) =
      make_float4(b[0] * s, b[1] * s, b[2] * s, b[3] * s);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared-memory layout, in 4-byte words: the tile's row offsets first (8-
// byte values at the aligned base), then fp32 arrays whose starts stay
// 16-byte aligned (hd is a multiple of 4, TT and the padding too).
struct Layout {
  int ld;                      // padded row stride of the K/V tiles
  int rows, ksc, vsc, qs, kt, vt, acc, p, m, l, alpha, words;
  __host__ __device__ Layout(int G, int hd) {
    ld = hd + 4;
    rows = 0;                  // [TT] long long
    ksc = rows + 2 * TT;       // [TT]
    vsc = ksc + TT;            // [TT]
    qs = vsc + TT;             // [G][hd] scaled queries
    kt = qs + G * hd;          // [TT][ld] dequantized K rows
    vt = kt + TT * ld;         // [TT][ld] dequantized V rows
    acc = vt + TT * ld;        // [G][hd]
    p = acc + G * hd;          // [G][TT] scores -> probabilities
    m = p + G * TT;            // [G]
    l = m + G;                 // [G]
    alpha = l + G;             // [G]
    words = alpha + G;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_gqa_decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ k_s,
                        const float* __restrict__ v_s,
                        const int* __restrict__ table,
                        const int* __restrict__ qpos,
                        float* __restrict__ out, int H, int KV, int hd,
                        int page, int pp, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int G = H / KV;
  const Layout L(G, hd);
  const int ld = L.ld;
  long long* rows = reinterpret_cast<long long*>(smem + L.rows);
  float* ksc = smem + L.ksc;
  float* vsc = smem + L.vsc;
  float* qs = smem + L.qs;
  float* kt = smem + L.kt;
  float* vt = smem + L.vt;
  float* acc = smem + L.acc;
  float* p = smem + L.p;
  float* m = smem + L.m;
  float* l = smem + L.l;
  float* alpha = smem + L.alpha;
  constexpr int VEC = 16 / sizeof(T);  // values per 16-byte load
  const int cpr = hd / VEC;            // 16-byte chunks per row

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int* trow = table + static_cast<size_t>(b) * pp;
  const int n_tok = min(qpos[b] + 1, pp * page);

  // the group's queries, with the score scale folded in (per-token K
  // scales make the fold free, as in the TPU kernel)
  for (int i = tid; i < G * hd; i += THREADS) {
    qs[i] = q[(static_cast<size_t>(b) * H + kv * G) * hd + i] * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m[g] = NEG;
    l[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < n_tok; t0 += TT) {
    const int nt = min(TT, n_tok - t0);
    // the tile's physical rows (element offsets of head kv) and scales
    for (int tt = tid; tt < TT; tt += THREADS) {
      long long at = -1;
      float ks = 0.f, vs = 0.f;
      if (tt < nt) {
        const int tok = t0 + tt;
        const long long row =
            static_cast<long long>(trow[tok / page]) * page + tok % page;
        at = (row * KV + kv) * hd;
        ks = k_s ? k_s[row] : 1.f;
        vs = v_s ? v_s[row] : 1.f;
      }
      rows[tt] = at;
      ksc[tt] = ks;
      vsc[tt] = vs;
    }
    __syncthreads();

    // dequantize the tile's K/V rows (zeros past the last valid row):
    // lanes run over tokens, BATCH independent 16-byte loads of each in
    // flight per thread before any is converted
    for (int i0 = tid; i0 < TT * cpr; i0 += THREADS * BATCH) {
      uint4 kx[BATCH], vx[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * THREADS;
        kx[u] = vx[u] = make_uint4(0, 0, 0, 0);
        if (i < TT * cpr) {
          const long long at = rows[i % TT];
          if (at >= 0) {
            const long long off = at + static_cast<long long>(i / TT) * VEC;
            kx[u] = *reinterpret_cast<const uint4*>(k + off);
            vx[u] = *reinterpret_cast<const uint4*>(v + off);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * THREADS;
        if (i < TT * cpr) {
          const int tt = i % TT, d = (i / TT) * VEC;
          dequant16(kx[u], ksc[tt], kt + tt * ld + d, T());
          dequant16(vx[u], vsc[tt], vt + tt * ld + d, T());
        }
      }
    }
    __syncthreads();

    // scores: one (head, token) pair per warp at a time
    for (int pr = warp; pr < G * TT; pr += WARPS) {
      const int g = pr / TT, tt = pr - g * TT;
      if (tt >= nt) {                  // warp-uniform
        if (lane == 0) p[pr] = NEG;
        continue;
      }
      float s = 0.f;
      for (int d = lane; d < hd; d += 32) s += qs[g * hd + d] * kt[tt * ld + d];
      s = warp_sum(s);
      if (lane == 0) p[pr] = s;
    }
    __syncthreads();

    // online softmax update, one warp per head
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG;
      for (int tt = lane; tt < TT; tt += 32) mx = fmaxf(mx, p[g * TT + tt]);
      const float m_old = m[g];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int tt = lane; tt < TT; tt += 32) {
        const float e = tt < nt ? expf(p[g * TT + tt] - m_new) : 0.f;
        p[g * TT + tt] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        l[g] = l[g] * a + sum;
        m[g] = m_new;
        alpha[g] = a;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * alpha + sum_t p[g][t] * v_t[d]
    for (int i = tid; i < G * hd; i += THREADS) {
      const int g = i / hd, d = i - g * hd;
      float a = acc[i] * alpha[g];
      for (int tt = 0; tt < nt; ++tt) a += p[g * TT + tt] * vt[tt * ld + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * hd; i += THREADS) {
    const int g = i / hd;
    out[(static_cast<size_t>(b) * H + kv * G) * hd + i] =
        acc[i] / fmaxf(l[g], 1e-30f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* k_s,
           const void* v_s, const void* table, const void* qpos, void* out,
           int B, int H, int KV, int hd, int page, int pp, float scale,
           cudaStream_t stream) {
  if (hd % (16 / static_cast<int>(sizeof(T))) != 0 || hd % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * Layout(H / KV, hd).words;
  cudaError_t err = cudaFuncSetAttribute(
      paged_gqa_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(KV, B);
  paged_gqa_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(k_s),
      static_cast<const float*>(v_s), static_cast<const int*>(table),
      static_cast<const int*>(qpos), static_cast<float*>(out), H, KV, hd,
      page, pp, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// storage: 0 = E4M3 bytes, 1 = bf16, 2 = fp32
extern "C" int paged_gqa_decode(const void* q, const void* k, const void* v,
                                const void* k_s, const void* v_s,
                                const void* table, const void* qpos,
                                void* out, int B, int H, int KV, int hd,
                                int page, int pp, float scale, int storage,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (storage) {
    case 0:
      return launch<uint8_t>(q, k, v, k_s, v_s, table, qpos, out, B, H, KV,
                             hd, page, pp, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, k_s, v_s, table, qpos, out, B, H,
                                   KV, hd, page, pp, scale, s);
    case 2:
      return launch<float>(q, k, v, k_s, v_s, table, qpos, out, B, H, KV, hd,
                           page, pp, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
