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
// cores, register-blocked so that shared memory feeds them fast enough.
//
// The split pass is mla_split.cuh's, with the paged row source (PagedRows):
// one CTA of 512 threads per (split of rps rows, group of 16 heads, slot);
// the wrapper's planner picks rps (a whole number of pages, 64-128 rows)
// and the number of splits S from the shapes alone. A CTA whose split
// starts past its slot's qpos returns at once; the others look their rows
// up in the page table (one read a row) and copy them with cp.async
// through three raw stages (E4M3) or two (bf16). The combine pass, one CTA
// per (head, slot), reads qpos on the card for the slot's split count and
// merges the partial softmaxes (split_kv.cuh). Dense-ring decode
// (mla_decode.cu) runs the same split pass over its rings.
#include "mla_split.cuh"

namespace {

template <typename T, int NS>
__global__ void __launch_bounds__(mla::THREADS, 1)
paged_mla_decode_split(const mla::Params a) {
  mla::split<T, NS, mla::PagedRows>(a);
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
  if (!mla::shapes_ok(R, Rr, rps) || rps % page != 0 ||
      static_cast<long long>(rps) * S < static_cast<long long>(pp) * page)
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(ws);
  const size_t bhs = static_cast<size_t>(B) * H * S;
  mla::Params a{};
  a.q_abs = static_cast<const float*>(q_abs);
  a.q_rope = static_cast<const float*>(q_rope);
  a.ckv = ckv;
  a.kr = kr;
  a.ckv_s = static_cast<const float*>(ckv_s);
  a.kr_s = static_cast<const float*>(kr_s);
  a.table = static_cast<const int*>(table);
  a.qpos = static_cast<const int*>(qpos);
  a.pacc = w;
  a.pm = w + bhs * R;
  a.pl = w + bhs * R + bhs;
  a.H = H;
  a.R = R;
  a.Rr = Rr;
  a.page = page;
  a.pp = pp;
  a.rps = rps;
  a.S = S;
  a.scale = scale;
  int err;
  switch (storage) {
    case 0:
      err = mla::launch_split<uint8_t, 3>(paged_mla_decode_split<uint8_t, 3>,
                                          a, B, st);
      break;
    case 1:
      err = mla::launch_split<__nv_bfloat16, 2>(
          paged_mla_decode_split<__nv_bfloat16, 2>, a, B, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  paged_mla_decode_combine<<<dim3(H, B), splitkv::combine_threads(R),
                             sizeof(float) * S, st>>>(
      a.pm, a.pl, a.pacc, a.qpos, static_cast<float*>(out), H, S, R,
      pp * page, rps);
  return static_cast<int>(cudaGetLastError());
}
