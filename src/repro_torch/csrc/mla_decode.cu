// Dense-ring MLA absorbed decode for Hopper (sm_90a), split-KV with a
// combine pass.
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
// What bounds it on an H100: fp32 arithmetic on the CUDA cores, 2*H*(2R +
// Rr) flops per valid row (q_abs is genuinely fp32, and the tolerance is
// 2e-5), against R + Rr cache values per row: at four slots of DeepSeek-V3
// (H = 128, R = 512, Rr = 64) with full rings of 1024, 1.14 GFLOP over
// 4.7 MB of bf16 rows, 0.017 ms at the fp32 peak.
//
// The design is paged_mla_decode.cu's split-KV pass (mla_split.cuh) with
// the ring as its row source (RingRows):
//   split pass, one CTA of 512 threads per (split of rps ring rows, group
//   of 16 heads, slot); the wrapper's planner picks rps (64 or 128 rows,
//   a multiple of the 32-row tile) and the number of splits S from the
//   shapes and the SM count alone, so nothing reads pos or qpos on the
//   host and the call captures in a CUDA graph (B = 4, H = 128, T = 1024:
//   64 rows x 16 splits, 512 CTAs). Each CTA reads its split's pos (one
//   read a row) and keeps the valid rows in ascending order (a warp
//   ballot and a prefix over the warps), so only valid rows are copied
//   (cp.async) and scored: a stale row (pos > qpos) or an empty one (-1)
//   costs one int read, and the run time follows the valid rows. bf16
//   rings go through two raw stages and are widened to fp32; fp32 rings
//   are copied straight into two fp32 tiles (the smoke width's cache; at
//   R + Rr = 576 raw fp32 stages would not fit the 227 KB of shared
//   memory). Every CTA writes its heads' (m, l), NEG and 0 for a split
//   without a valid row, and its accumulators where it had one;
//   combine pass, one CTA per (head, slot), over all S splits, skipping a
//   split whose l is 0 (split_kv.cuh, ring mode).
// Shared memory of the split kernels at R = 512, Rr = 64 (mla_split.cuh):
// bf16 222,208 bytes, fp32 222,720 at rps = 128.
#include "mla_split.cuh"

namespace {

template <typename T, int NS>
__global__ void __launch_bounds__(mla::THREADS, 1)
mla_decode_split(const mla::Params a) {
  mla::split<T, NS, mla::RingRows>(a);
}

__global__ void __launch_bounds__(splitkv::COMBINE_THREADS)
mla_decode_combine(const float* __restrict__ pm, const float* __restrict__ pl,
                   const float* __restrict__ pacc, float* __restrict__ out,
                   int H, int S, int R) {
  splitkv::combine<true>(pm, pl, pacc, nullptr, out, H, S, R, 0, 1);
}

}  // namespace

// cache: 0 = fp32 (rows copied straight into fp32 tiles), 1 = bf16 (two raw
// stages). ws: the partials, B*H*S*R floats of accumulators then B*H*S of m
// and of l. Launches the split pass, then the combine pass, on `stream`.
extern "C" int mla_decode(const void* q_abs, const void* q_rope,
                          const void* ckv, const void* kr, const void* pos,
                          const void* qpos, void* out, void* ws, int B, int H,
                          int R, int Rr, int T, int rps, int S, float scale,
                          int cache, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mla::shapes_ok(R, Rr, rps) ||
      static_cast<long long>(rps) * S < static_cast<long long>(T))
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(ws);
  const size_t bhs = static_cast<size_t>(B) * H * S;
  mla::Params a{};
  a.q_abs = static_cast<const float*>(q_abs);
  a.q_rope = static_cast<const float*>(q_rope);
  a.ckv = ckv;
  a.kr = kr;
  a.pos = static_cast<const int*>(pos);
  a.qpos = static_cast<const int*>(qpos);
  a.pacc = w;
  a.pm = w + bhs * R;
  a.pl = w + bhs * R + bhs;
  a.H = H;
  a.R = R;
  a.Rr = Rr;
  a.T = T;
  a.rps = rps;
  a.S = S;
  a.scale = scale;
  int err;
  switch (cache) {
    case 0:
      err = mla::launch_split<float, 0>(mla_decode_split<float, 0>, a, B, st);
      break;
    case 1:
      err = mla::launch_split<__nv_bfloat16, 2>(
          mla_decode_split<__nv_bfloat16, 2>, a, B, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  mla_decode_combine<<<dim3(H, B), splitkv::combine_threads(R),
                       sizeof(float) * S, st>>>(
      a.pm, a.pl, a.pacc, static_cast<float*>(out), H, S, R);
  return static_cast<int>(cudaGetLastError());
}
