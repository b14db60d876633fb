// Paged GQA decode for Hopper (sm_90a), split-KV with a combine pass.
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
// What bounds it on an H100: bytes. At G = 5 each K/V row (2*hd bytes of
// E4M3 and 8 of scales) feeds 5 heads, about 10 flops a byte, far below
// the card's ridge. So the design's one job is to keep many rows in
// flight on every SM:
//
//   split pass, one CTA of 128 threads per (split of rps rows, KV head,
//   slot); the wrapper's planner picks rps (a whole number of pages, 64-128
//   rows) and the number of splits S from the shapes alone, so the grid
//   never depends on qpos. A CTA whose split starts past its slot's qpos
//   returns at once. The others:
//     1. copy the group's G queries asynchronously and look their rows up in
//        the page table (one read a row); the score scale is folded into q
//        once it lands, as in the TPU kernel;
//     2. copy every K row, then every V row, of the split at once with
//        16-byte asynchronous copies (cp.async, LDGSTS) into shared memory,
//        neighbouring threads on neighbouring 16 bytes of a row, rows padded
//        to an odd count of 16-byte units (conflict-free row-per-thread
//        reads). Rows past qpos are never copied and never read, so what a
//        freed row holds cannot reach the output;
//     3. once K has landed (V still in flight), each thread scores one row
//        against all G heads in registers: no shuffle per score;
//     4. a warp per head takes the split's max and sum of exp with warp
//        reductions and writes the split's (m, l);
//     5. once V has landed, each thread accumulates (G heads x 4 dims) in
//        registers over a quarter of the rows; the four warps' sums meet in
//        shared memory and the unnormalised accumulator is written once;
//   combine pass, one CTA per (head, slot): reads qpos on the card for the
//   slot's split count and merges the partial softmaxes (split_kv.cuh).
//
// G is a template parameter for G = 1, 2, 4, 5 and 8 (qwen3-14b has 5) and
// a runtime value up to 16 otherwise. A row of hd values must fill whole
// 16-byte vectors and the split's K and V rows must fit the shared memory
// (the wrapper checks both).
#include "split_kv.cuh"

namespace {

using splitkv::NEG;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int DIMS = 128;      // output dims a warp covers in one PV pass

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) / 16 * 16; }

// Shared-memory layout, in bytes, every array 16-byte aligned.
struct Layout {
  int ld;                      // K/V row stride: odd count of 16 B units
  size_t k, v, q, p, rows, ksc, vsc, red, total;
  __host__ __device__ Layout(int G, int hd, int esize, int rps) {
    ld = ((hd * esize / 16) | 1) * 16;
    k = 0;                                      // [rps][ld] raw K rows
    v = k + static_cast<size_t>(rps) * ld;      // [rps][ld] raw V rows
    q = v + static_cast<size_t>(rps) * ld;      // [G][hd] scaled queries
    p = q + up16(4ull * G * hd);                // [G][rps] scores -> exp
    rows = p + up16(4ull * G * rps);            // [rps] element offsets
    ksc = rows + up16(8ull * rps);              // [rps]
    vsc = ksc + up16(4ull * rps);               // [rps]
    red = vsc + up16(4ull * rps);               // [WARPS][G][DIMS]
    total = red + 4ull * WARPS * G * DIMS;
  }
};

struct Params {
  const float* q;
  const void* k;
  const void* v;
  const float* k_s;
  const float* v_s;
  const int* table;
  const int* qpos;
  float* pm;                   // (B, H, S)
  float* pl;                   // (B, H, S)
  float* pacc;                 // (B, H, S, hd)
  int H, KV, hd, page, pp, rps, S;
  float scale;
};

template <typename T, int GM, bool EXACT>
__global__ void __launch_bounds__(THREADS)
paged_gqa_decode_split(const Params a) {
  const int G = EXACT ? GM : a.H / a.KV;
  const int s = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int n_tok = splitkv::slot_tokens(a.qpos, b, a.pp * a.page);
  const int t0 = s * a.rps;
  if (t0 >= n_tok) return;
  const int nv = min(a.rps, n_tok - t0);   // rows of this split <= qpos
  const int hd = a.hd, rps = a.rps;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(G, hd, sizeof(T), rps);
  unsigned char* kraw = smem + L.k;
  unsigned char* vraw = smem + L.v;
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ps = reinterpret_cast<float*>(smem + L.p);
  long long* rows = reinterpret_cast<long long*>(smem + L.rows);
  float* ksc = reinterpret_cast<float*>(smem + L.ksc);
  float* vsc = reinterpret_cast<float*>(smem + L.vsc);
  float* red = reinterpret_cast<float*>(smem + L.red);
  constexpr int VEC = 16 / sizeof(T);      // values per 16-byte vector
  const int cpr = hd / VEC;                // 16-byte vectors per row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // 1. the group's G queries (contiguous in q), then the split's rows, as
  // asynchronous copies; the scales land with K
  const float* qb = a.q + (static_cast<size_t>(b) * a.H + kv * G) * hd;
  for (int i = tid; i < G * hd / 4; i += THREADS)
    splitkv::cp_async(qs + 4 * i, qb + 4 * i, 16);
  splitkv::cp_async_commit();
  const int* trow = a.table + static_cast<size_t>(b) * a.pp;
  for (int t = tid; t < nv; t += THREADS) {
    const int tok = t0 + t;
    const long long row =
        static_cast<long long>(trow[tok / a.page]) * a.page + tok % a.page;
    rows[t] = (row * a.KV + kv) * hd;
    if (a.k_s) {
      splitkv::cp_async(ksc + t, a.k_s + row, 4);
      splitkv::cp_async(vsc + t, a.v_s + row, 4);
    } else {
      ksc[t] = vsc[t] = 1.f;
    }
  }
  __syncthreads();

  // 2. every K row, then every V row, in flight at once: neighbouring
  // threads on neighbouring 16 bytes of a row
  auto copy_rows = [&](unsigned char* dst, const T* src) {
    for (int i = tid; i < nv * cpr; i += THREADS) {
      const int t = i / cpr, c = i - t * cpr;
      splitkv::cp_async(dst + t * L.ld + c * 16, src + rows[t] + c * VEC, 16);
    }
    splitkv::cp_async_commit();
  };
  copy_rows(kraw, static_cast<const T*>(a.k));
  copy_rows(vraw, static_cast<const T*>(a.v));
  splitkv::cp_async_wait<1>();             // q, the scales and K have landed
  __syncthreads();
  for (int i = tid; i < G * hd / 4; i += THREADS) {   // fold the score scale
    float4* x = reinterpret_cast<float4*>(qs) + i;
    *x = make_float4(x->x * a.scale, x->y * a.scale, x->z * a.scale,
                     x->w * a.scale);
  }
  __syncthreads();

  // 3. scores: a row per thread, every head of the group in registers
  for (int t = tid; t < nv; t += THREADS) {
    float sc[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) sc[g] = 0.f;
    const uint4* kr = reinterpret_cast<const uint4*>(kraw + t * L.ld);
    const float ks = ksc[t];
    for (int c = 0; c < cpr; ++c) {
      const uint4 x = kr[c];
#pragma unroll
      for (int j = 0; j < VEC / 4; ++j) {
        const float4 kk =
            splitkv::Four<T>::widen(splitkv::word<T>(x, j), ks);
        const int d = c * VEC + 4 * j;
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float4 qq = *reinterpret_cast<const float4*>(qs + g * hd + d);
            sc[g] = fmaf(qq.x, kk.x, fmaf(qq.y, kk.y,
                    fmaf(qq.z, kk.z, fmaf(qq.w, kk.w, sc[g]))));
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) ps[g * rps + t] = sc[g];
  }
  __syncthreads();

  // 4. the split's softmax state, a warp per head
  const size_t bh0 = static_cast<size_t>(b) * a.H + kv * G;
  for (int g = warp; g < G; g += WARPS) {
    float* pg = ps + g * rps;
    float mx = NEG;
    for (int t = lane; t < nv; t += 32) mx = fmaxf(mx, pg[t]);
    mx = splitkv::warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < nv; t += 32) {
      const float e = expf(pg[t] - mx);
      pg[t] = e;
      sum += e;
    }
    sum = splitkv::warp_sum(sum);
    if (lane == 0) {
      a.pm[(bh0 + g) * a.S + s] = mx;
      a.pl[(bh0 + g) * a.S + s] = sum;
    }
  }
  splitkv::cp_async_wait<0>();             // V has landed
  __syncthreads();

  // 5. P·V: (G heads x 4 dims) a thread over rows warp, warp+4, ...; the
  // four warps' sums meet in shared memory
  for (int d0 = 0; d0 < hd; d0 += DIMS) {
    const int d = d0 + 4 * lane;
    float acc[GM][4];
#pragma unroll
    for (int g = 0; g < GM; ++g)
      acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
    if (d < hd) {
      for (int t = warp; t < nv; t += WARPS) {
        const float4 x =
            splitkv::load4<T>(vraw + t * L.ld + d * sizeof(T), vsc[t]);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float pt = ps[g * rps + t];
            acc[g][0] = fmaf(pt, x.x, acc[g][0]);
            acc[g][1] = fmaf(pt, x.y, acc[g][1]);
            acc[g][2] = fmaf(pt, x.z, acc[g][2]);
            acc[g][3] = fmaf(pt, x.w, acc[g][3]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G)
        *reinterpret_cast<float4*>(red + (warp * G + g) * DIMS + 4 * lane) =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    __syncthreads();
    const int dw = min(DIMS, hd - d0);
    for (int i = tid; i < G * dw; i += THREADS) {
      const int g = i / dw, dd = i - g * dw;
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) o += red[(w * G + g) * DIMS + dd];
      a.pacc[((bh0 + g) * a.S + s) * hd + d0 + dd] = o;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(splitkv::COMBINE_THREADS)
paged_gqa_decode_combine(const float* __restrict__ pm,
                         const float* __restrict__ pl,
                         const float* __restrict__ pacc,
                         const int* __restrict__ qpos,
                         float* __restrict__ out, int H, int S, int hd,
                         int rows, int rps) {
  splitkv::combine(pm, pl, pacc, qpos, out, H, S, hd, rows, rps);
}

template <typename T, int GM, bool EXACT>
int launch_split(const Params& a, int B, cudaStream_t stream) {
  const size_t smem = Layout(a.H / a.KV, a.hd, sizeof(T), a.rps).total;
  auto kernel = paged_gqa_decode_split<T, GM, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.S, a.KV, B), THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Params& a, int B, cudaStream_t stream) {
  if (a.hd % (16 / static_cast<int>(sizeof(T))) != 0 || a.hd % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (a.H / a.KV) {
    case 1: return launch_split<T, 1, true>(a, B, stream);
    case 2: return launch_split<T, 2, true>(a, B, stream);
    case 4: return launch_split<T, 4, true>(a, B, stream);
    case 5: return launch_split<T, 5, true>(a, B, stream);
    case 8: return launch_split<T, 8, true>(a, B, stream);
    default: return launch_split<T, 16, false>(a, B, stream);
  }
}

}  // namespace

// storage: 0 = E4M3 bytes, 1 = bf16, 2 = fp32. ws: the partials, B*H*S*hd
// floats of accumulators then B*H*S of m and of l. Launches the split
// pass, then the combine pass, on `stream`.
extern "C" int paged_gqa_decode(const void* q, const void* k, const void* v,
                                const void* k_s, const void* v_s,
                                const void* table, const void* qpos,
                                void* out, void* ws, int B, int H, int KV,
                                int hd, int page, int pp, int rps, int S,
                                float scale, int storage, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || H / KV > 16 || rps <= 0 || rps % page != 0 ||
      static_cast<long long>(rps) * S < static_cast<long long>(pp) * page)
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(ws);
  const size_t bhs = static_cast<size_t>(B) * H * S;
  const Params a{static_cast<const float*>(q), k, v,
                 static_cast<const float*>(k_s),
                 static_cast<const float*>(v_s),
                 static_cast<const int*>(table),
                 static_cast<const int*>(qpos), w + bhs * hd,
                 w + bhs * hd + bhs, w, H, KV, hd, page, pp, rps, S, scale};
  int err;
  switch (storage) {
    case 0: err = launch<uint8_t>(a, B, st); break;
    case 1: err = launch<__nv_bfloat16>(a, B, st); break;
    case 2: err = launch<float>(a, B, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  paged_gqa_decode_combine<<<dim3(H, B), splitkv::combine_threads(hd),
                             sizeof(float) * S, st>>>(
      a.pm, a.pl, a.pacc, a.qpos, static_cast<float*>(out), H, S, hd,
      pp * page, rps);
  return static_cast<int>(cudaGetLastError());
}
