// Paged MLA absorbed decode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/
// paged_attention.py:paged_mla_decode_kernel. Per slot b and head h:
//   s_t = (q_abs[b,h]·ckv_t + q_rope[b,h]·kr_t) * scale,  t = 0..qpos[b]
//   o[b,h] = sum_t softmax(s)_t * ckv_t                    (fp32, (B,H,R))
// where row t of slot b lives in physical page table[b, t / page] at offset
// t % page, dequantized as value * per-token scale (E4M3 bytes through the
// exact cuda_fp8.h conversion, or bf16 pools with unit scales).
//
// One block of 256 threads per (group of HG heads, slot). The block loads
// its own qpos and table row and loops over the slot's tokens in TT-token
// tiles (the in-block loop replaces the TPU's sequential page axis),
// stopping at the tile that holds qpos: rows above qpos are masked in the
// reference, so the output is the same. Per tile: the rows are dequantized
// into shared memory; each warp computes scores for (head, token) pairs
// with a warp-sum; an online softmax (m, l per head) rescales the fp32
// accumulator acc[HG][R], also in shared memory, each element owned by one
// thread.
//
// Bound on an H100: the fp32 arithmetic (~2*H*(2R+Rr) flops per resident
// token on the CUDA cores) more than the bytes (R+Rr+8 per token). B*H/HG
// blocks (64 at B=4, H=128) underfill the 132 SMs: splitting a slot's
// pages across blocks (split-KV) and combining the partial softmaxes in a
// second pass is the next step.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int HG = 8;          // heads per block
constexpr int TT = 16;         // tokens per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float load_val(const uint8_t* p, size_t i) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(p[i], __NV_E4M3);
  return __half2float(__half(h));
}
__device__ __forceinline__ float load_val(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_mla_decode_kernel(const float* __restrict__ q_abs,
                        const float* __restrict__ q_rope,
                        const T* __restrict__ ckv, const T* __restrict__ kr,
                        const float* __restrict__ ckv_s,
                        const float* __restrict__ kr_s,
                        const int* __restrict__ table,
                        const int* __restrict__ qpos,
                        float* __restrict__ out, int H, int R, int Rr,
                        int page, int pp, float scale) {
  extern __shared__ float smem[];
  const int RR = R + Rr;
  float* qa = smem;                    // [HG][RR]  scaled queries
  float* tile = qa + HG * RR;          // [TT][RR]  dequantized rows
  float* acc = tile + TT * RR;         // [HG][R]
  float* p = acc + HG * R;             // [HG][TT]  scores -> probabilities
  float* m = p + HG * TT;              // [HG]
  float* l = m + HG;                   // [HG]
  float* alpha = l + HG;               // [HG]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int h0 = blockIdx.x * HG;
  const int nh = min(HG, H - h0);
  const int* trow = table + static_cast<size_t>(b) * pp;
  const int n_tok = min(qpos[b] + 1, pp * page);

  // queries, with the score scale folded in (per-token scales make the
  // fold free, as in the TPU kernel)
  for (int i = tid; i < HG * RR; i += THREADS) {
    const int h = i / RR, d = i % RR;
    float v = 0.f;
    if (h < nh) {
      const size_t bh = static_cast<size_t>(b) * H + h0 + h;
      v = (d < R ? q_abs[bh * R + d] : q_rope[bh * Rr + (d - R)]) * scale;
    }
    qa[i] = v;
  }
  for (int i = tid; i < HG * R; i += THREADS) acc[i] = 0.f;
  if (tid < HG) {
    m[tid] = NEG;
    l[tid] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < n_tok; t0 += TT) {
    // dequantize this tile's rows (zeros past the last valid row)
    for (int i = tid; i < TT * RR; i += THREADS) {
      const int tt = i / RR, d = i % RR;
      const int tok = t0 + tt;
      float v = 0.f;
      if (tok < n_tok) {
        const size_t row = static_cast<size_t>(trow[tok / page]) * page +
                           tok % page;
        v = d < R ? load_val(ckv, row * R + d) * ckv_s[row]
                  : load_val(kr, row * Rr + (d - R)) * kr_s[row];
      }
      tile[i] = v;
    }
    __syncthreads();

    // scores: one (head, token) pair per warp at a time
    for (int pr = warp; pr < HG * TT; pr += WARPS) {
      const int h = pr / TT, tt = pr % TT;
      float s = 0.f;
      for (int d = lane; d < RR; d += 32) s += qa[h * RR + d] * tile[tt * RR + d];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) p[pr] = (h < nh && t0 + tt < n_tok) ? s : NEG;
    }
    __syncthreads();

    // online softmax update, one thread per head
    if (tid < HG) {
      const int h = tid;
      float mx = NEG;
      for (int tt = 0; tt < TT; ++tt) mx = fmaxf(mx, p[h * TT + tt]);
      const float m_new = fmaxf(m[h], mx);
      const float a = expf(m[h] - m_new);
      float sum = 0.f;
      for (int tt = 0; tt < TT; ++tt) {
        const bool valid = t0 + tt < n_tok;
        const float e = valid ? expf(p[h * TT + tt] - m_new) : 0.f;
        p[h * TT + tt] = e;
        sum += e;
      }
      l[h] = l[h] * a + sum;
      m[h] = m_new;
      alpha[h] = a;
    }
    __syncthreads();

    // acc[h][d] = acc * alpha + sum_t p[h][t] * ckv_t[d]
    for (int i = tid; i < HG * R; i += THREADS) {
      const int h = i / R, d = i % R;
      float a = acc[i] * alpha[h];
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) a += p[h * TT + tt] * tile[tt * RR + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nh * R; i += THREADS) {
    const int h = i / R, d = i % R;
    out[(static_cast<size_t>(b) * H + h0 + h) * R + d] =
        acc[h * R + d] / fmaxf(l[h], 1e-30f);
  }
}

template <typename T>
int launch(const void* q_abs, const void* q_rope, const void* ckv,
           const void* kr, const void* ckv_s, const void* kr_s,
           const void* table, const void* qpos, void* out, int B, int H,
           int R, int Rr, int page, int pp, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(HG) * (R + Rr) + static_cast<size_t>(TT) * (R + Rr) +
       static_cast<size_t>(HG) * R + HG * TT + 3 * HG);
  cudaError_t err = cudaFuncSetAttribute(
      paged_mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((H + HG - 1) / HG, B);
  paged_mla_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q_abs), static_cast<const float*>(q_rope),
      static_cast<const T*>(ckv), static_cast<const T*>(kr),
      static_cast<const float*>(ckv_s), static_cast<const float*>(kr_s),
      static_cast<const int*>(table), static_cast<const int*>(qpos),
      static_cast<float*>(out), H, R, Rr, page, pp, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// storage: 0 = E4M3 bytes, 1 = bf16
extern "C" int paged_mla_decode(const void* q_abs, const void* q_rope,
                                const void* ckv, const void* kr,
                                const void* ckv_s, const void* kr_s,
                                const void* table, const void* qpos,
                                void* out, int B, int H, int R, int Rr,
                                int page, int pp, float scale, int storage,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0:
      return launch<uint8_t>(q_abs, q_rope, ckv, kr, ckv_s, kr_s, table,
                             qpos, out, B, H, R, Rr, page, pp, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q_abs, q_rope, ckv, kr, ckv_s, kr_s,
                                   table, qpos, out, B, H, R, Rr, page, pp,
                                   scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
