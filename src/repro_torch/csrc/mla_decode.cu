// Dense-ring MLA absorbed decode for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mla_attention/
// mla_attention.py:mla_decode_kernel. Per slot b and head h:
//   s_t = (q_abs[b,h]·ckv[b,t] + q_rope[b,h]·kr[b,t]) * scale
//   valid_t = pos[b,t] >= 0 && pos[b,t] <= qpos[b]
//   o[b,h] = sum_t softmax(s)_t * ckv[b,t]       (fp32, (B,H,R))
// over the slot's whole ring of T rows: the ring is written at
// position % T, so valid rows can sit anywhere, and validity is read from
// pos row by row. A slot with no valid row comes out zero (acc = l = 0),
// as the Pallas kernel's does.
//
// One block of 256 threads (8 warps) per (group of HG = 8 heads, slot).
// The block loops over the ring in TT = 32-row tiles (the in-block loop
// replaces the TPU's sequential block axis). Per tile:
//   1. each of the first 32 threads reads one row's pos; a block-wide vote
//      (__syncthreads_or) skips the tile when no row of it is valid;
//   2. the rows, contiguous in the ring, are read as 16-byte vectors (four
//      in flight per thread) and widened to fp32 in shared memory, rows
//      padded to an odd count of 16-byte units so that a warp reading 32
//      rows at once hits distinct banks; rows past T (a ragged last tile)
//      are zero and masked;
//   3. warp w scores head w against the tile, lane t against row t, and
//      keeps head w's online softmax (m, l) in registers, reduced across
//      the warp with shuffles;
//   4. the fp32 accumulator acc[HG][R] in shared memory is rescaled and
//      gains sum_t p[t][h] * ckv_t, each thread owning 4 heads x 4 dims.
//
// Bound on an H100: the fp32 arithmetic, 2*H*(2R+Rr) flops per valid row
// on the CUDA cores, over R+Rr cache values per row. B*H/HG blocks (64 at
// B=4, H=128) fill half the 132 SMs: split-KV (a slot's ring across
// blocks, partial softmaxes combined in a second pass) is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int HG = 8;          // heads per block, one warp each
constexpr int TT = 32;         // ring rows per tile, one lane each
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
static_assert(HG == WARPS, "one warp per head");
static_assert(HG % 4 == 0, "P·V items span 4 heads");
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// shared-memory row stride of a tile: R+Rr floats padded to an odd count
// of 16-byte units (conflict-free 16-byte reads of 32 rows at one column)
__host__ __device__ inline int row_stride(int RR) {
  return RR + (((RR / 4) % 2 == 0) ? 4 : 0);
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // values per 16-byte vector
  __device__ static void store(float* dst, const uint4& v) {
    *reinterpret_cast<uint4*>(dst) = v;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void store(float* dst, const uint4& v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    const float2 f0 = __bfloat1622float2(h[0]);
    const float2 f1 = __bfloat1622float2(h[1]);
    const float2 f2 = __bfloat1622float2(h[2]);
    const float2 f3 = __bfloat1622float2(h[3]);
    reinterpret_cast<float4*>(dst)[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
    reinterpret_cast<float4*>(dst)[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
};

// Widen `nrows` contiguous rows of `width` values (from `src`) into
// columns [col0, col0 + width) of the tile; rows nrows..TT-1 become zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* tile, int col0,
                                          const T* __restrict__ src,
                                          int width, int nrows, int rrp) {
  const int vpr = width / Vec<T>::N;
  const int nvec = TT * vpr;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int base = threadIdx.x; base < nvec; base += 4 * THREADS) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * THREADS;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nvec && i / vpr < nrows) v[u] = __ldg(s + i);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * THREADS;
      if (i < nvec)
        Vec<T>::store(tile + (i / vpr) * rrp + col0 + (i % vpr) * Vec<T>::N,
                      v[u]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mla_decode_kernel(const float* __restrict__ q_abs,
                  const float* __restrict__ q_rope,
                  const T* __restrict__ ckv, const T* __restrict__ kr,
                  const int* __restrict__ pos, const int* __restrict__ qpos,
                  float* __restrict__ out, int H, int R, int Rr, int T_len,
                  float scale) {
  extern __shared__ __align__(16) float smem[];
  const int RR = R + Rr;
  const int rrp = row_stride(RR);
  float* qa = smem;                    // [HG][RR]   scaled queries
  float* tile = qa + HG * RR;          // [TT][rrp]  fp32 rows
  float* acc = tile + TT * rrp;        // [HG][R]
  float* p = acc + HG * R;             // [TT][HG]   probabilities
  float* alpha = p + TT * HG;          // [HG]       rescale of this tile
  float* lsum = alpha + HG;            // [HG]
  int* vrow = reinterpret_cast<int*>(lsum + HG);   // [TT] row valid

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int h0 = blockIdx.x * HG;
  const int nh = min(HG, H - h0);
  const int qp = qpos[b];

  // queries with the score scale folded in (heads past H are zero)
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
  // online-softmax state of head `warp`, the same in every lane
  float m = NEG, l = 0.f;
  __syncthreads();

  const T* ckv_b = ckv + static_cast<size_t>(b) * T_len * R;
  const T* kr_b = kr + static_cast<size_t>(b) * T_len * Rr;
  const int* pos_b = pos + static_cast<size_t>(b) * T_len;
  const int cols = R / 4;
  const int items = (HG / 4) * cols;

  for (int t0 = 0; t0 < T_len; t0 += TT) {
    const int nrows = min(TT, T_len - t0);
    bool valid = false;
    if (tid < nrows) {
      const int ps = pos_b[t0 + tid];
      valid = ps >= 0 && ps <= qp;
    }
    if (tid < TT) vrow[tid] = valid;
    if (!__syncthreads_or(valid)) continue;    // no valid row in the tile

    load_rows<T>(tile, 0, ckv_b + static_cast<size_t>(t0) * R, R, nrows,
                 rrp);
    load_rows<T>(tile, R, kr_b + static_cast<size_t>(t0) * Rr, Rr, nrows,
                 rrp);
    __syncthreads();

    {  // scores and softmax: warp = head, lane = row
      const float4* q4 = reinterpret_cast<const float4*>(qa + warp * RR);
      const float4* k4 = reinterpret_cast<const float4*>(tile + lane * rrp);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int j = 0; j < RR / 4; ++j) {
        const float4 a = q4[j], c = k4[j];
        s0 = fmaf(a.x, c.x, s0);
        s1 = fmaf(a.y, c.y, s1);
        s2 = fmaf(a.z, c.z, s2);
        s3 = fmaf(a.w, c.w, s3);
      }
      const bool ok = vrow[lane] != 0;
      const float s = ok ? (s0 + s1) + (s2 + s3) : NEG;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m, mx);
      const float e = ok ? expf(s - m_new) : 0.f;
      float sum = e;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      const float a = expf(m - m_new);
      l = l * a + sum;
      m = m_new;
      p[lane * HG + warp] = e;
      if (lane == 0) alpha[warp] = a;
    }
    __syncthreads();

    // acc[h][d] = acc * alpha[h] + sum_t p[t][h] * ckv_t[d]
    for (int c = tid; c < items; c += THREADS) {
      const int hq = (c / cols) * 4, d = (c % cols) * 4;
      float4 ac[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float a = alpha[hq + u];
        float4 v = *reinterpret_cast<const float4*>(acc + (hq + u) * R + d);
        ac[u] = make_float4(v.x * a, v.y * a, v.z * a, v.w * a);
      }
      for (int tt = 0; tt < nrows; ++tt) {
        const float4 v = *reinterpret_cast<const float4*>(tile + tt * rrp + d);
        const float4 w = *reinterpret_cast<const float4*>(p + tt * HG + hq);
        const float pw[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          ac[u].x = fmaf(pw[u], v.x, ac[u].x);
          ac[u].y = fmaf(pw[u], v.y, ac[u].y);
          ac[u].z = fmaf(pw[u], v.z, ac[u].z);
          ac[u].w = fmaf(pw[u], v.w, ac[u].w);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(acc + (hq + u) * R + d) = ac[u];
    }
    __syncthreads();
  }

  if (lane == 0) lsum[warp] = l;
  __syncthreads();
  for (int i = tid; i < nh * R; i += THREADS) {
    const int h = i / R, d = i % R;
    out[(static_cast<size_t>(b) * H + h0 + h) * R + d] =
        acc[h * R + d] / fmaxf(lsum[h], 1e-30f);
  }
}

template <typename T>
int launch(const void* q_abs, const void* q_rope, const void* ckv,
           const void* kr, const void* pos, const void* qpos, void* out,
           int B, int H, int R, int Rr, int T_len, float scale,
           cudaStream_t stream) {
  const size_t RR = static_cast<size_t>(R) + Rr;
  const size_t smem =
      sizeof(float) * (HG * RR + TT * static_cast<size_t>(row_stride(R + Rr)) +
                       static_cast<size_t>(HG) * R + TT * HG + 2 * HG) +
      sizeof(int) * TT;
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((H + HG - 1) / HG, B);
  mla_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q_abs), static_cast<const float*>(q_rope),
      static_cast<const T*>(ckv), static_cast<const T*>(kr),
      static_cast<const int*>(pos), static_cast<const int*>(qpos),
      static_cast<float*>(out), H, R, Rr, T_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cache: 0 = fp32, 1 = bf16
extern "C" int mla_decode(const void* q_abs, const void* q_rope,
                          const void* ckv, const void* kr, const void* pos,
                          const void* qpos, void* out, int B, int H, int R,
                          int Rr, int T, float scale, int cache,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache) {
    case 0:
      return launch<float>(q_abs, q_rope, ckv, kr, pos, qpos, out, B, H, R,
                           Rr, T, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q_abs, q_rope, ckv, kr, pos, qpos, out, B,
                                   H, R, Rr, T, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
