// MLA absorbed decode, the split pass that paged_mla_decode.cu (rows of a
// paged pool) and mla_decode.cu (rows of a slot's dense ring) share.
//
// Per slot b and head h the two ops compute
//   s_t = (q_abs[b,h]·ckv_t + q_rope[b,h]·kr_t) * scale
//   o[b,h] = sum_t softmax(s)_t * ckv_t                    (fp32, (B,H,R))
// over the slot's valid rows t. The split pass runs one CTA of 512 threads
// per (split s of rps rows, group of HG = 16 heads, slot b), grid (S,
// ceil(H/16), B), and writes the split's softmax state for its heads into
// the workspace of split_kv.cuh (m, l and the unnormalised accumulator);
// a combine pass merges the splits.
//
// Where a split's rows come from is the row source (Src):
//   PagedRows  rows t0..t0+rps-1 of the slot's logical sequence below
//              min(qpos + 1, pp*page), looked up through the page table,
//              with per-token scales (E4M3 pools) or null scale pointers
//              (unit scales, bf16 pools). A split past qpos writes nothing:
//              the combine reads qpos for the slot's split count.
//   RingRows   ring rows t0..min(t0+rps, T)-1, of which those with
//              0 <= pos <= qpos are kept, in ascending row order (a warp
//              ballot over one row a thread, a prefix over the warps: the
//              order is fixed, so the result is the same on every call),
//              with unit scales. Valid rows may sit in any split (the ring
//              is written at position % T), so every split writes its m
//              and l: NEG and 0 when it holds no valid row, and the
//              combine skips a split whose l is 0.
// Only the kept rows are ever copied, so what an empty, stale or freed row
// holds cannot reach the output.
//
// From there the pass is one code for both sources. The CTA copies its 16
// heads' queries asynchronously (the score scale is folded in once they
// land) and walks its nv kept rows in TT = 32-row tiles:
//   - E4M3 and bf16 rows: a ring of NS raw stages; each tile's ckv and kr
//     rows are copied as bytes with asynchronous 16-byte copies (cp.async,
//     LDGSTS; 8 or 4 bytes where a row is narrower), NS - 1 tiles ahead,
//     and widened once into fp32 rows of the tile, times the row's scale;
//     rows past the last kept one are zeros there and masked;
//   - fp32 rows (NS = 0, "direct"): no raw stage and no widening; the rows
//     are copied straight into one of two padded fp32 tiles, one tile
//     ahead (at R + Rr = 576 two raw fp32 stages and the tile would need
//     about 290 KB, over the 227 KB a CTA may have);
//   - scores (16 x (R+Rr)) · ((R+Rr) x 32): each of the 16 warps takes a
//     sixteenth of the R+Rr columns, each lane a 4-head x 4-row block from
//     float4 reads (conflict-free: rows padded to an odd count of 16-byte
//     units); the partial tiles meet in shared memory;
//   - the online softmax, a warp per head, a lane per row, with warp
//     reductions;
//   - P·V (16 x 32) · (32 x R): each thread keeps a 4-head x 4-dim block of
//     the accumulator in registers, rescaled per head, and reads the tile
//     once per row for its four heads.
// At the end each CTA writes its heads' (m, l) and unnormalised
// accumulators once.
//
// Shared memory (Layout, bytes) at R = 512, Rr = 64 and rps = 128, the
// most the planners give: queries 37,120, one fp32 tile 74,240, the
// partial scores 32,768, 4,352 of probabilities, rows, scales and state;
// raw stages of 18,432 (E4M3) or 36,864 (bf16) bytes. E4M3 with three
// stages: 203,776; bf16 with two: 222,208; fp32 direct (a second tile, no
// stage): 222,720. One CTA fills an SM, so its
// 16 warps are what hides the latencies. The entries check R % 4 == 0,
// R <= 512 (a thread owns 4 of the accumulator's columns), Rr % 4 == 0
// and rps <= 512 (RingRows: one row a thread).
#pragma once

#include "split_kv.cuh"

namespace mla {

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

// Shared-memory layout, in bytes, every array 16-byte aligned. ns raw
// stages of esize-byte values and one fp32 tile, or (ns == 0) two fp32
// tiles that the rows are copied into directly.
struct Layout {
  int K;                       // R + Rr
  int kld;                     // fp32 row stride: an odd count of float4s
  int rld;                     // raw row stride in bytes
  size_t q, tile, raw, red, p, rows, csc, ksc, cnt, m, l, alpha, total;
  __host__ __device__ Layout(int R, int Rr, int esize, int rps, int ns) {
    K = R + Rr;
    kld = K + (((K / 4) % 2 == 0) ? 4 : 0);
    rld = static_cast<int>(up16(static_cast<size_t>(K) * esize));
    const int tiles = ns == 0 ? 2 : 1;
    q = 0;                                       // [HG][kld] scaled queries
    tile = q + 4ull * HG * kld;                  // [tiles][TT][kld] fp32 rows
    raw = tile + 4ull * tiles * TT * kld;        // [ns][TT][rld] bytes
    red = raw + static_cast<size_t>(ns) * TT * rld;  // [WARPS][HG][TT]
    p = red + 4ull * WARPS * HG * TT;            // [TT][HG] probabilities
    rows = p + 4ull * TT * HG;                   // [rps] rows to read
    csc = rows + up16(8ull * rps);               // [rps] ckv scales
    ksc = csc + up16(4ull * rps);                // [rps] kr scales
    cnt = ksc + up16(4ull * rps);                // [WARPS] kept rows a warp
    m = cnt + 4 * WARPS;                         // [HG]
    l = m + 4 * HG;                              // [HG]
    alpha = l + 4 * HG;                          // [HG]
    total = alpha + 4 * HG;
  }
};

struct Params {
  const float* q_abs;          // (B, H, R)
  const float* q_rope;         // (B, H, Rr)
  const void* ckv;             // rows of R values
  const void* kr;              // rows of Rr values
  const float* ckv_s;          // PagedRows: per-row scales, or null (unit)
  const float* kr_s;
  const int* table;            // PagedRows: (B, pp)
  const int* pos;              // RingRows: (B, T)
  const int* qpos;             // (B,)
  float* pm;                   // (B, H, S)
  float* pl;                   // (B, H, S)
  float* pacc;                 // (B, H, S, R)
  int H, R, Rr;
  int page, pp;                // PagedRows
  int T;                       // RingRows: rows a slot
  int rps, S;
  float scale;
};

struct PagedRows {
  static constexpr bool WRITE_EMPTY = false;
  // the split's rows at or below qpos (the same in every thread)
  __device__ static int count(const Params& a, int b, int s, long long*,
                              int*) {
    const int n_tok = splitkv::slot_tokens(a.qpos, b, a.pp * a.page);
    return max(0, min(a.rps, n_tok - s * a.rps));
  }
  // pool rows through the page table (one read a row), and their scales
  __device__ static void fill(const Params& a, int b, int s, int nv,
                              long long* rows, float* csc, float* ksc) {
    const int t0 = s * a.rps;
    const int* trow = a.table + static_cast<size_t>(b) * a.pp;
    for (int t = threadIdx.x; t < nv; t += THREADS) {
      const int tok = t0 + t;
      const long long row =
          static_cast<long long>(trow[tok / a.page]) * a.page + tok % a.page;
      rows[t] = row;
      if (a.ckv_s) {                      // lands with the first tile
        splitkv::cp_async(csc + t, a.ckv_s + row, 4);
        splitkv::cp_async(ksc + t, a.kr_s + row, 4);
      } else {
        csc[t] = ksc[t] = 1.f;
      }
    }
  }
};

struct RingRows {
  static constexpr bool WRITE_EMPTY = true;
  // keeps the split's rows with 0 <= pos <= qpos in rows[] (as ring rows
  // of the whole (B, T) cache), ascending; returns their count (the same
  // in every thread). Every thread must call it.
  __device__ static int count(const Params& a, int b, int s,
                              long long* rows, int* cnt) {
    const int t0 = s * a.rps;
    const int n = min(a.rps, a.T - t0);  // a ragged last split
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const size_t base = static_cast<size_t>(b) * a.T + t0;
    bool ok = false;
    if (tid < n) {
      const int p = a.pos[base + tid];
      ok = p >= 0 && p <= a.qpos[b];
    }
    const unsigned vote = __ballot_sync(splitkv::FULL, ok);
    if (lane == 0) cnt[warp] = __popc(vote);
    __syncthreads();
    int before = 0, nv = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = cnt[w];
      before += w < warp ? c : 0;
      nv += c;
    }
    if (ok)
      rows[before + __popc(vote & ((1u << lane) - 1u))] =
          static_cast<long long>(base + tid);
    return nv;
  }
  __device__ static void fill(const Params&, int, int, int nv, long long*,
                              float* csc, float* ksc) {
    for (int t = threadIdx.x; t < nv; t += THREADS) csc[t] = ksc[t] = 1.f;
  }
};

__device__ __forceinline__ float dot4(const float4& x, const float4& y,
                                      float acc) {
  return fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w, acc))));
}

// The split pass over rows of type T (uint8_t: E4M3 bytes, __nv_bfloat16,
// float) through NS raw stages (NS = 0: fp32 rows copied directly).
template <typename T, int NS, class Src>
__device__ __forceinline__ void split(const Params& a) {
  constexpr bool DIRECT = NS == 0;
  static_assert(!DIRECT || sizeof(T) == 4, "direct copies are fp32 rows");
  const int s = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int R = a.R, Rr = a.Rr;
  const int h0 = grp * HG, nh = min(HG, a.H - h0);
  const size_t bh0 = static_cast<size_t>(b) * a.H + h0;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(R, Rr, sizeof(T), a.rps, NS);
  const int K = L.K, K4 = K / 4, kld = L.kld, rld = L.rld;
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* tiles = reinterpret_cast<float*>(smem + L.tile);
  unsigned char* raw = smem + L.raw;
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* pb = reinterpret_cast<float*>(smem + L.p);
  long long* rows = reinterpret_cast<long long*>(smem + L.rows);
  float* csc = reinterpret_cast<float*>(smem + L.csc);
  float* ksc = reinterpret_cast<float*>(smem + L.ksc);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  float* mh = reinterpret_cast<float*>(smem + L.m);
  float* lh = reinterpret_cast<float*>(smem + L.l);
  float* alpha = reinterpret_cast<float*>(smem + L.alpha);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int nv = Src::count(a, b, s, rows, cnt);
  if (nv == 0) {                         // no row of this split is valid
    if (Src::WRITE_EMPTY && tid < nh) {
      a.pm[(bh0 + tid) * a.S + s] = NEG;
      a.pl[(bh0 + tid) * a.S + s] = 0.f;
    }
    return;
  }

  // the group's queries, copied asynchronously into their padded rows
  // (zeros for heads past H), then the split's rows and scales
  for (int h = warp; h < HG; h += WARPS) {
    float* dst = qs + h * kld;
    if (h < nh) {
      const size_t bh = bh0 + h;
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
  Src::fill(a, b, s, nv, rows, csc, ksc);
  if (tid < HG) {
    mh[tid] = NEG;
    lh[tid] = 0.f;
  }
  __syncthreads();

  // asynchronous copies of a tile's rows into its raw stage (or its fp32
  // tile), in the largest granule that divides both parts of a row
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
      unsigned char* dst;
      int stride;
      if constexpr (DIRECT) {
        dst = reinterpret_cast<unsigned char*>(tiles + (it & 1) * TT * kld);
        stride = 4 * kld;
      } else {
        dst = raw + static_cast<size_t>(it % NS) * TT * rld;
        stride = rld;
      }
      for (int t = warp; t < n; t += WARPS) {     // a warp per row
        const long long row = rows[r0 + t];
        for (int c = lane; c < ncr; c += 32) {
          const unsigned char* src =
              c < nc ? ckv + row * cb + c * gran
                     : kr + row * kb + (c - nc) * gran;
          splitkv::cp_async(dst + t * stride + c * gran, src, gran);
        }
      }
    }
    splitkv::cp_async_commit();          // an empty group past the end
  };
  constexpr int AHEAD = DIRECT ? 1 : NS - 1;
#pragma unroll
  for (int it = 0; it < AHEAD; ++it) copy_tile(it);

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
    if constexpr (DIRECT) {
      splitkv::cp_async_wait<0>();       // tile it (and the queries) landed
      __syncthreads();                   // and every warp is past tile it-1
      copy_tile(it + 1);                 // into the tile it - 1 used
    } else {
      copy_tile(it + NS - 1);
      splitkv::cp_async_wait<NS - 1>();  // tile it (and the queries) landed
      __syncthreads();
    }
    const int r0 = it * TT, n = min(TT, nv - r0);
    if (it == 0) {                       // fold the score scale into q
      for (int h = warp; h < nh; h += WARPS)
        for (int j = lane; j < K4; j += 32) {
          float4* x = reinterpret_cast<float4*>(qs + h * kld + 4 * j);
          *x = make_float4(x->x * a.scale, x->y * a.scale, x->z * a.scale,
                           x->w * a.scale);
        }
    }

    const float* tile = tiles;
    if constexpr (DIRECT) {
      // rows past n hold an older tile's rows (or nothing yet): their
      // scores are masked and P·V stops at n
      tile = tiles + (it & 1) * TT * kld;
      if (it == 0) __syncthreads();      // the folded queries
    } else {
      // widen the tile to fp32, a warp per row (zeros past the last row)
      const unsigned char* src =
          raw + static_cast<size_t>(it % NS) * TT * rld;
      for (int t = warp; t < TT; t += WARPS) {
        const bool ok = t < n;
        const float sc = ok ? csc[r0 + t] : 0.f, sk = ok ? ksc[r0 + t] : 0.f;
        for (int j = lane; j < K4; j += 32) {
          const int d = 4 * j;
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (ok) x = splitkv::load4<T>(src + t * rld + d * sizeof(T),
                                        d < R ? sc : sk);
          *reinterpret_cast<float4*>(tiles + t * kld + d) = x;
        }
      }
      __syncthreads();
    }

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

// Set the split kernel's shared memory and launch it on grid (S,
// ceil(H/16), B).
template <typename T, int NS>
int launch_split(void (*kernel)(Params), const Params& a, int B,
                 cudaStream_t stream) {
  const size_t smem = Layout(a.R, a.Rr, sizeof(T), a.rps, NS).total;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();        // reported here: not left for the next launch
    return static_cast<int>(err);
  }
  kernel<<<dim3(a.S, (a.H + HG - 1) / HG, B), THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the checks both entries make (cudaErrorInvalidValue if one fails)
inline bool shapes_ok(int R, int Rr, int rps) {
  return R % 4 == 0 && R <= MAX_R && Rr % 4 == 0 && rps > 0 &&
         rps <= THREADS;
}

}  // namespace mla
