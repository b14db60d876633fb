// Flash bucketed-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py:flash_prefill_kernel. For batch b, query row r and
// query head h (KV head h / G, G = H / KV):
//   s_t = (q[b,r,h]·k[b,t,h/G]) * scale
//   valid_t = k_pos[b,t] >= 0 && (!causal || k_pos[b,t] <= q_pos[b,r])
//   o[b,r,h] = sum_t softmax over valid t (s)_t * v[b,t,h/G]   (fp32)
// and a row with no valid key gives zeros (the empty online softmax), as
// the reference does. q (B,S,H,hd), k/v (B,T,KV,hd) in the compute dtype,
// positions int32, out (B,S,H,hd) fp32.
//
// Both paths run one block per (query block, head, batch) and walk the key
// blocks of the bucket in order with an fp32 online softmax (m, l, acc):
// the in-block loop replaces the TPU grid's sequential key axis. A key
// block with no valid (row, key) pair for any row of the block (the upper
// triangle under causal, or all pads) is skipped, which halves the work of
// causal prefill without assuming anything about the positions' order.
//
// * bf16 operands: 4 warps x 16 query rows, 64-key blocks, tensor cores
//   through mma.sync m16n8k16 (csrc/mma.cuh) with fp32 accumulation. Q
//   stays in registers as A fragments; S = Q·Kᵀ lands in the accumulator
//   layout, which is reused as the A fragments of P·V after rounding P to
//   bf16 (l sums the unrounded fp32 P). V is stored transposed in shared
//   memory so its B fragments are 32-bit loads. hd in {32, 64, 128}.
// * fp32 operands: CUDA-core fp32 FMAs (no TF32, no bf16 rounding), 16
//   query rows x 32-key blocks, one (row, key) score per thread. hd <= 256.
//
// Bound on an H100: causal prefill at bucket 2048, 40 heads, hd 128 is
// ~43 GFLOP against ~70 MB of operands: the tensor cores (989 TFLOP/s
// bf16) bound it, not the bytes. This first version uses mma.sync from
// synchronous loads into shared memory; wgmma fed by TMA with a
// warp-specialised producer is the fast form, for a later PR.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "mma.cuh"

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ bool key_valid(int kp, int qp, bool causal) {
  return kp >= 0 && (!causal || kp <= qp);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BQ16 = 64;       // query rows per block (16 per warp)
constexpr int BK16 = 64;       // keys per block
constexpr int THREADS16 = 128;

template <int HD>
struct Bf16Smem {
  static constexpr int QK_STRIDE = HD + 8;   // bf16, pads banks apart
  static constexpr int VT_STRIDE = BK16 + 8;
  static constexpr size_t bytes() {
    return sizeof(__nv_bfloat16) *
               (static_cast<size_t>(BQ16) * QK_STRIDE +
                static_cast<size_t>(BK16) * QK_STRIDE +
                static_cast<size_t>(HD) * VT_STRIDE) +
           sizeof(int) * (BQ16 + BK16 + 1);
  }
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack16(__bfloat16_as_ushort(__float2bfloat16_rn(lo)),
                __bfloat16_as_ushort(__float2bfloat16_rn(hi)));
}

template <int HD>
__global__ void __launch_bounds__(THREADS16)
flash_prefill_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ k_pos,
                          float* __restrict__ out, int S, int T, int H,
                          int KV, bool causal, float scale) {
  using L = Bf16Smem<HD>;
  constexpr int NKK = HD / 16;     // k-steps of Q·Kᵀ
  constexpr int NO = HD / 8;       // n-tiles of the output
  constexpr int NS = BK16 / 8;     // n-tiles of the scores
  constexpr int CH = HD / 8;       // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(raw);
  __nv_bfloat16* ks = qs + BQ16 * L::QK_STRIDE;
  __nv_bfloat16* vt = ks + BK16 * L::QK_STRIDE;      // [HD][BK16]
  int* qps = reinterpret_cast<int*>(vt + HD * L::VT_STRIDE);
  int* kps = qps + BQ16;
  int* qmax_s = kps + BK16;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // Q block -> shared memory (zeros past S), positions of its rows
  for (int i = tid; i < BQ16 * CH; i += THREADS16) {
    const int r = i / CH, c = (i - r * CH) * 8;
    uint4 x = zero;
    if (q0 + r < S)
      x = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * S + q0 + r) * H + h) * HD + c);
    *reinterpret_cast<uint4*>(qs + r * L::QK_STRIDE + c) = x;
  }
  if (tid < BQ16)
    qps[tid] = q0 + tid < S ? q_pos[static_cast<size_t>(b) * S + q0 + tid]
                            : INT_MIN;
  __syncthreads();
  if (tid == 0) {
    int mx = INT_MIN;
    for (int r = 0; r < BQ16; ++r) mx = max(mx, qps[r]);
    *qmax_s = mx;
  }

  // this warp's 16 rows as A fragments, for every k-step
  const int wr = warp * 16;
  uint32_t qf[NKK][4];
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) {
    const __nv_bfloat16* r0 = qs + (wr + g) * L::QK_STRIDE + kk * 16 + 2 * t4;
    const __nv_bfloat16* r1 = r0 + 8 * L::QK_STRIDE;
    qf[kk][0] = ld32(r0);
    qf[kk][1] = ld32(r1);
    qf[kk][2] = ld32(r0 + 8);
    qf[kk][3] = ld32(r1 + 8);
  }
  const int qp0 = qps[wr + g], qp1 = qps[wr + g + 8];
  __syncthreads();
  const int qmax = *qmax_s;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < T; k0 += BK16) {
    int kp = -1;
    if (tid < BK16) {
      kp = k0 + tid < T ? k_pos[static_cast<size_t>(b) * T + k0 + tid] : -1;
      kps[tid] = kp;
    }
    // skip a key block that no row of this block may attend
    if (!__syncthreads_or(tid < BK16 && key_valid(kp, qmax, causal)))
      continue;

    // K block -> shared memory; V block -> transposed shared memory
    for (int i = tid; i < BK16 * CH; i += THREADS16) {
      const int r = i / CH, c = (i - r * CH) * 8;
      uint4 x = zero;
      if (k0 + r < T)
        x = *reinterpret_cast<const uint4*>(
            k + ((static_cast<size_t>(b) * T + k0 + r) * KV + kvh) * HD + c);
      *reinterpret_cast<uint4*>(ks + r * L::QK_STRIDE + c) = x;
    }
    for (int i = tid; i < BK16 * CH; i += THREADS16) {
      const int r = i % BK16, c = (i / BK16) * 8;    // lanes over keys
      uint4 x = zero;
      if (k0 + r < T)
        x = *reinterpret_cast<const uint4*>(
            v + ((static_cast<size_t>(b) * T + k0 + r) * KV + kvh) * HD + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * L::VT_STRIDE + r] = e[j];
    }
    __syncthreads();

    // S = Q·Kᵀ for this warp's 16 rows x 64 keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * L::QK_STRIDE + kk * 16 +
                                  2 * t4;
        const uint32_t bf[2] = {ld32(kr), ld32(kr + 8)};
        mma_bf16_16816(s[n], qf[kk], bf);
      }
    }

    // mask, scale, and the online-softmax step for rows g and g + 8
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpc = kps[n * 8 + 2 * t4 + j];
        s[n][j] = key_valid(kpc, qp0, causal) ? s[n][j] * scale : NEG;
        s[n][2 + j] = key_valid(kpc, qp1, causal) ? s[n][2 + j] * scale : NEG;
        mx0 = fmaxf(mx0, s[n][j]);
        mx1 = fmaxf(mx1, s[n][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpc = kps[n * 8 + 2 * t4 + j];
        const float p0 = key_valid(kpc, qp0, causal) ? expf(s[n][j] - mn0)
                                                      : 0.f;
        const float p1 = key_valid(kpc, qp1, causal)
                             ? expf(s[n][2 + j] - mn1) : 0.f;
        s[n][j] = p0;
        s[n][2 + j] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    }
    l0 = l0 * a0 + sum0;           // per-lane partial sums, reduced at the end
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // O += P·V: the score accumulators are the A fragments of P
#pragma unroll
    for (int jk = 0; jk < BK16 / 16; ++jk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * jk][0], s[2 * jk][1]),
                              pack_bf16(s[2 * jk][2], s[2 * jk][3]),
                              pack_bf16(s[2 * jk + 1][0], s[2 * jk + 1][1]),
                              pack_bf16(s[2 * jk + 1][2], s[2 * jk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vr = vt + (n * 8 + g) * L::VT_STRIDE + jk * 16 +
                                  2 * t4;
        const uint32_t bf[2] = {ld32(vr), ld32(vr + 8)};
        mma_bf16_16816(o[n], pa, bf);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int r0 = q0 + wr + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t4;
    if (r0 < S)
      *reinterpret_cast<float2*>(
          out + ((static_cast<size_t>(b) * S + r0) * H + h) * HD + c) =
          make_float2(o[n][0] / d0, o[n][1] / d0);
    if (r1 < S)
      *reinterpret_cast<float2*>(
          out + ((static_cast<size_t>(b) * S + r1) * H + h) * HD + c) =
          make_float2(o[n][2] / d1, o[n][3] / d1);
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

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* q_pos, const void* k_pos, void* out, int B, int S,
                int T, int H, int KV, bool causal, float scale,
                cudaStream_t stream) {
  const size_t smem = Bf16Smem<HD>::bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_bf16_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ16 - 1) / BQ16, H, B);
  flash_prefill_bf16_kernel<HD><<<grid, THREADS16, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<float*>(out), S, T, H, KV,
      causal, scale);
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

// dtype: 0 = bf16 (hd 32, 64 or 128), 1 = fp32 (hd <= 256)
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
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
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
