// Paged MLA absorbed decode for Hopper (sm_90a), split-KV with a combine
// pass.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/
// paged_attention.py:paged_mla_decode_kernel. Per slot b and head h:
//   s_t = (q_abs[b,h]·ckv_t + q_rope[b,h]·kr_t) * scale,  t = 0..qpos[b]
//   o[b,h] = sum_t softmax(s)_t * ckv_t                    (fp32, (B,H,R))
// where row t of slot b lives in physical page table[b, t / page] at offset
// t % page, dequantized as value * per-token scale (E4M3 bytes through the
// exact cuda_fp8.h conversion, or bf16 pools with null scale pointers, which
// stand for unit scales).
//
// What bounds it on an H100: fp32 arithmetic. At H = 128 each 584-byte
// latent row feeds 128 heads x 2*(2R + Rr) flops, about 480 flops a byte,
// and q_abs is genuinely fp32 (one bf16 tensor-core pass would not hold the
// 2e-5 tolerance). So the design runs two small fp32 GEMMs on the CUDA
// cores, register-blocked so that shared memory feeds them fast enough:
//
//   split pass, one CTA of 512 threads per (split of rps rows, group of
//   HG = 16 heads, slot); the wrapper's planner picks rps (a whole number of
//   pages, 64-128 rows) and the number of splits S from the shapes alone. A
//   CTA whose split starts past its slot's qpos returns at once. The others
//   copy the queries of their 16 heads asynchronously (the score scale is
//   folded into them once they land), look their rows up in the page table
//   (one read a row) and walk the split in TT = 32-row tiles:
//     - a ring of NS raw stages: each tile's ckv and kr rows are copied as
//       bytes with asynchronous 16-byte copies (cp.async, LDGSTS; 8 or 4
//       bytes where a row is narrower), NS - 1 tiles ahead of the one in use;
//     - the tile is widened once into fp32 rows in shared memory, times the
//       per-token scale; rows past qpos are zeros there and masked, and
//       their bytes are never copied, so what a freed row holds cannot reach
//       the output;
//     - scores (16 x (R+Rr)) · ((R+Rr) x 32): each of the 16 warps takes a
//       sixteenth of the R+Rr columns, each lane a 4-head x 4-row block from
//       float4 reads (conflict-free: rows padded to an odd count of 16-byte
//       units); the partial tiles meet in shared memory;
//     - the online softmax, a warp per head, a lane per row, with warp
//       reductions;
//     - P·V (16 x 32) · (32 x R): each thread keeps a 4-head x 4-dim block of
//       the accumulator in registers, rescaled per head, and reads the tile
//       once per row for its four heads.
//   At the end each CTA writes its heads' (m, l) and unnormalised
//   accumulators once. The combine pass, one CTA per (head, slot), reads
//   qpos on the card for the slot's split count and merges the partial
//   softmaxes (split_kv.cuh).
//
// One CTA fills an SM's shared memory (about 190 KB), so its 16 warps are
// what hides the latencies. The wrapper checks R % 4 == 0, R <= 512 (a
// thread owns 4 of the accumulator's columns) and Rr % 4 == 0.
#include "split_kv.cuh"

namespace {

using splitkv::NEG;

constexpr int HG = 16;         // heads per CTA
constexpr int TT = 32;         // rows per tile
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_R = THREADS;           // 4 dims a thread, 4 threads a dim
static_assert(HG == WARPS, "softmax: a head a warp");
static_assert(TT == 32, "softmax: a lane a row");
static_assert(HG == 16, "scores: a warp covers 16 heads x 32 rows");

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) / 16 * 16; }

// Shared-memory layout, in bytes, every array 16-byte aligned.
struct Layout {
  int K;                       // R + Rr
  int kld;                     // fp32 row stride: an odd count of float4s
  int rld;                     // raw row stride in bytes
  size_t q, tile, raw, red, p, rows, csc, ksc, m, l, alpha, total;
  __host__ __device__ Layout(int R, int Rr, int esize, int rps, int ns) {
    K = R + Rr;
    kld = K + (((K / 4) % 2 == 0) ? 4 : 0);
    rld = static_cast<int>(up16(static_cast<size_t>(K) * esize));
    q = 0;                                       // [HG][kld] scaled queries
    tile = q + 4ull * HG * kld;                  // [TT][kld] widened rows
    raw = tile + 4ull * TT * kld;                // [ns][TT][rld] bytes
    red = raw + static_cast<size_t>(ns) * TT * rld;  // [WARPS][HG][TT]
    p = red + 4ull * WARPS * HG * TT;            // [TT][HG] probabilities
    rows = p + 4ull * TT * HG;                   // [rps] pool rows
    csc = rows + up16(8ull * rps);               // [rps] ckv scales
    ksc = csc + up16(4ull * rps);                // [rps] kr scales
    m = ksc + up16(4ull * rps);                  // [HG]
    l = m + 4 * HG;                              // [HG]
    alpha = l + 4 * HG;                          // [HG]
    total = alpha + 4 * HG;
  }
};

struct Params {
  const float* q_abs;
  const float* q_rope;
  const void* ckv;
  const void* kr;
  const float* ckv_s;
  const float* kr_s;
  const int* table;
  const int* qpos;
  float* pm;                   // (B, H, S)
  float* pl;                   // (B, H, S)
  float* pacc;                 // (B, H, S, R)
  int H, R, Rr, page, pp, rps, S;
  float scale;
};

__device__ __forceinline__ float dot4(const float4& x, const float4& y,
                                      float acc) {
  return fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, acc))));
}

template <typename T, int NS>
__global__ void __launch_bounds__(THREADS, 1)
paged_mla_decode_split(const Params a) {
  const int s = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int n_tok = splitkv::slot_tokens(a.qpos, b, a.pp * a.page);
  const int t0 = s * a.rps;
  if (t0 >= n_tok) return;
  const int nv = min(a.rps, n_tok - t0);   // rows of this split <= qpos
  const int R = a.R, Rr = a.Rr;
  const int h0 = grp * HG, nh = min(HG, a.H - h0);

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(R, Rr, sizeof(T), a.rps, NS);
  const int K = L.K, K4 = K / 4, kld = L.kld, rld = L.rld;
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* tile = reinterpret_cast<float*>(smem + L.tile);
  unsigned char* raw = smem + L.raw;
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* pb = reinterpret_cast<float*>(smem + L.p);
  long long* rows = reinterpret_cast<long long*>(smem + L.rows);
  float* csc = reinterpret_cast<float*>(smem + L.csc);
  float* ksc = reinterpret_cast<float*>(smem + L.ksc);
  float* mh = reinterpret_cast<float*>(smem + L.m);
  float* lh = reinterpret_cast<float*>(smem + L.l);
  float* alpha = reinterpret_cast<float*>(smem + L.alpha);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the group's queries, copied asynchronously into their padded rows
  // (zeros for heads past H), then the split's rows and scales
  for (int h = warp; h < HG; h += WARPS) {
    float* dst = qs + h * kld;
    if (h < nh) {
      const size_t bh = static_cast<size_t>(b) * a.H + h0 + h;
      for (int j = lane; j < R / 4; j += 32)
        splitkv::cp_async(dst + 4 * j, a.q_abs + bh * R + 4 * j, 16);
      for (int j = lane; j < Rr / 4; j += 32)
        splitkv::cp_async(dst + R + 4 * j, a.q_rope + bh * Rr + 4 * j, 16);
    } else {
      for (int j = lane; j < K4; j += 32)
        *reinterpret_cast<float4*>(dst + 4 * j) = make_float4(0.f, 0.f, 0.f,
                                                              0.f);
    }
  }
  splitkv::cp_async_commit();
  const int* trow = a.table + static_cast<size_t>(b) * a.pp;
  for (int t = tid; t < nv; t += THREADS) {
    const int tok = t0 + t;
    const long long row =
        static_cast<long long>(trow[tok / a.page]) * a.page + tok % a.page;
    rows[t] = row;
    if (a.ckv_s) {                        // lands with the first tile
      splitkv::cp_async(csc + t, a.ckv_s + row, 4);
      splitkv::cp_async(ksc + t, a.kr_s + row, 4);
    } else {
      csc[t] = ksc[t] = 1.f;
    }
  }
  if (tid < HG) {
    mh[tid] = NEG;
    lh[tid] = 0.f;
  }
  __syncthreads();

  // asynchronous copies of a tile's rows into its raw stage, in the largest
  // granule that divides both parts of a row
  const int cb = R * static_cast<int>(sizeof(T));
  const int kb = Rr * static_cast<int>(sizeof(T));
  const int gran = (cb % 16 == 0 && kb % 16 == 0) ? 16
                   : (cb % 8 == 0 && kb % 8 == 0)  ? 8
                                                   : 4;
  const int nc = cb / gran, ncr = nc + kb / gran;
  const unsigned char* ckv = static_cast<const unsigned char*>(a.ckv);
  const unsigned char* kr = static_cast<const unsigned char*>(a.kr);
  const int ntiles = (nv + TT - 1) / TT;
  auto copy_tile = [&](int it) {
    if (it < ntiles) {
      const int r0 = it * TT, n = min(TT, nv - r0);
      unsigned char* dst = raw + static_cast<size_t>(it % NS) * TT * rld;
      for (int t = warp; t < n; t += WARPS) {     // a warp per row
        const long long row = rows[r0 + t];
        for (int c = lane; c < ncr; c += 32) {
          const unsigned char* src =
              c < nc ? ckv + row * cb + c * gran
                     : kr + row * kb + (c - nc) * gran;
          splitkv::cp_async(dst + t * rld + c * gran, src, gran);
        }
      }
    }
    splitkv::cp_async_commit();          // an empty group past the end
  };
#pragma unroll
  for (int it = 0; it < NS - 1; ++it) copy_tile(it);

  // both GEMMs: lane -> heads hq + 4i; scores: rows rg + 8j; P·V: dims
  // 4*dc .. 4*dc + 3
  const int hq = lane & 3, rg = lane >> 2, dc = warp * 8 + rg;
  const bool pv = 4 * dc < R;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    copy_tile(it + NS - 1);
    splitkv::cp_async_wait<NS - 1>();    // tile it (and the queries) landed
    __syncthreads();
    const int r0 = it * TT, n = min(TT, nv - r0);
    if (it == 0) {                       // fold the score scale into q
      for (int h = warp; h < nh; h += WARPS)
        for (int j = lane; j < K4; j += 32) {
          float4* x = reinterpret_cast<float4*>(qs + h * kld + 4 * j);
          *x = make_float4(x->x * a.scale, x->y * a.scale, x->z * a.scale,
                           x->w * a.scale);
        }
    }

    // widen the tile to fp32, a warp per row (zeros past the last valid row)
    const unsigned char* src = raw + static_cast<size_t>(it % NS) * TT * rld;
    for (int t = warp; t < TT; t += WARPS) {
      const bool ok = t < n;
      const float sc = ok ? csc[r0 + t] : 0.f, sk = ok ? ksc[r0 + t] : 0.f;
      for (int j = lane; j < K4; j += 32) {
        const int d = 4 * j;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) x = splitkv::load4<T>(src + t * rld + d * sizeof(T),
                                      d < R ? sc : sk);
        *reinterpret_cast<float4*>(tile + t * kld + d) = x;
      }
    }
    __syncthreads();

    // partial scores over this warp's columns
    float sa[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sa[i][j] = 0.f;
    for (int c4 = warp; c4 < K4; c4 += WARPS) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (hq + 4 * i) * kld +
                                                 4 * c4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(tile + (rg + 8 * j) * kld +
                                                 4 * c4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sa[i][j] = dot4(qv[i], kv[j], sa[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[(warp * HG + hq + 4 * i) * TT + rg + 8 * j] = sa[i][j];
    __syncthreads();

    // online softmax: warp -> head, lane -> row
    {
      const int h = warp;
      float sv = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sv += red[(w * HG + h) * TT + lane];
      const bool ok = lane < n;
      const float m_old = mh[h];
      const float m_new = fmaxf(m_old, splitkv::warp_max(ok ? sv : NEG));
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float sum = splitkv::warp_sum(p);
      pb[lane * HG + (h & 3) * 4 + (h >> 2)] = p;   // heads h&3 + 4i as float4
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        lh[h] = lh[h] * al + sum;
        mh[h] = m_new;
        alpha[h] = al;
      }
    }
    __syncthreads();

    // P·V into the register accumulator
    if (pv) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float al = alpha[hq + 4 * i];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= al;
      }
      for (int t = 0; t < n; ++t) {
        const float4 p4 = *reinterpret_cast<const float4*>(pb + t * HG + hq * 4);
        const float4 v4 = *reinterpret_cast<const float4*>(tile + t * kld + 4 * dc);
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(p[i], v[e], acc[i][e]);
      }
    }
  }

  // the split's state, once
  const size_t bh0 = static_cast<size_t>(b) * a.H + h0;
  if (tid < nh) {
    a.pm[(bh0 + tid) * a.S + s] = mh[tid];
    a.pl[(bh0 + tid) * a.S + s] = lh[tid];
  }
  if (pv) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = hq + 4 * i;
      if (h < nh) {
        *reinterpret_cast<float4*>(a.pacc + ((bh0 + h) * a.S + s) * R +
                                   4 * dc) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
}

__global__ void __launch_bounds__(splitkv::COMBINE_THREADS)
paged_mla_decode_combine(const float* __restrict__ pm,
                         const float* __restrict__ pl,
                         const float* __restrict__ pacc,
                         const int* __restrict__ qpos,
                         float* __restrict__ out, int H, int S, int R,
                         int rows, int rps) {
  splitkv::combine(pm, pl, pacc, qpos, out, H, S, R, rows, rps);
}

template <typename T, int NS>
int launch(const Params& a, int B, cudaStream_t stream) {
  const size_t smem = Layout(a.R, a.Rr, sizeof(T), a.rps, NS).total;
  auto kernel = paged_mla_decode_split<T, NS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.S, (a.H + HG - 1) / HG, B), THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// storage: 0 = E4M3 bytes (three raw stages), 1 = bf16 (two). ws: the
// partials, B*H*S*R floats of accumulators then B*H*S of m and of l.
// Launches the split pass, then the combine pass, on `stream`.
extern "C" int paged_mla_decode(const void* q_abs, const void* q_rope,
                                const void* ckv, const void* kr,
                                const void* ckv_s, const void* kr_s,
                                const void* table, const void* qpos,
                                void* out, void* ws, int B, int H, int R,
                                int Rr, int page, int pp, int rps, int S,
                                float scale, int storage, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R % 4 != 0 || R > MAX_R || Rr % 4 != 0 || rps <= 0 ||
      rps % page != 0 ||
      static_cast<long long>(rps) * S < static_cast<long long>(pp) * page)
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(ws);
  const size_t bhs = static_cast<size_t>(B) * H * S;
  const Params a{static_cast<const float*>(q_abs),
                 static_cast<const float*>(q_rope), ckv, kr,
                 static_cast<const float*>(ckv_s),
                 static_cast<const float*>(kr_s),
                 static_cast<const int*>(table),
                 static_cast<const int*>(qpos), w + bhs * R,
                 w + bhs * R + bhs, w, H, R, Rr, page, pp, rps, S, scale};
  int err;
  switch (storage) {
    case 0: err = launch<uint8_t, 3>(a, B, st); break;
    case 1: err = launch<__nv_bfloat16, 2>(a, B, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  paged_mla_decode_combine<<<dim3(H, B), splitkv::combine_threads(R),
                             sizeof(float) * S, st>>>(
      a.pm, a.pl, a.pacc, a.qpos, static_cast<float*>(out), H, S, R,
      pp * page, rps);
  return static_cast<int>(cudaGetLastError());
}
