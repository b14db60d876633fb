"""Paged decode attention: the MLA absorbed and the GQA ops, each with
its plain version and CUDA launcher.

``paged_mla_decode``

Replaces the TPU kernel ``src/repro/kernels/paged_attention/
paged_attention.py`` (``paged_mla_decode_kernel``, :88; ``pallas_call``
at :123). Per slot it walks the page table, dequantizes each E4M3 latent
row by its per-token scale, and folds it into an online softmax:

    s = (q_abs·ckvᵀ + q_rope·krᵀ)·scale,  valid iff row <= qpos,
    o = Σ softmax(s)·ckv                       -> (B, H, R) fp32

The kernel (``csrc/paged_mla_decode.cu``) runs one thread block per (slot,
group of 8 heads): it loads its own table row and ``qpos``, and loops over
the slot's tokens in 16-token tiles — the in-block loop takes the place of
the TPU's sequential page axis. E4M3 bytes convert exactly through
``cuda_fp8.h`` and are scaled per token into shared memory; the softmax
state (m, l, acc[R]) stays fp32. The walk stops at the tile holding
``qpos``: rows above it are masked in the reference, so skipping them
gives the same output.

What bounds it on an H100: one decode step reads each slot's resident
latent rows once (R + Rr bytes + two fp32 scales per token), a few MB at
most — the fp32 arithmetic on the CUDA cores (~2·H·(2R + Rr) flops per
token) is the larger bound at H = 128. B x H/8 blocks (64 for four slots
of DeepSeek-V3) underfill the 132 SMs; splitting each slot's page run
across blocks (split-KV, with a second pass combining the partial
softmaxes) is a later PR.

``paged_gqa_decode``

Replaces ``paged_gqa_decode_kernel`` (same file, :171; ``pallas_call`` at
:218). The head axis factors as (KV, G): query heads ``kv*G .. kv*G+G-1``
share KV head ``kv``. Per slot and KV head it walks the page table,
dequantizes each K/V row by its per-token scale, scores the group's G
heads against it and folds the scores into an online softmax:

    s = q·kᵀ·scale,  valid iff row <= qpos,  o = Σ softmax(s)·v
                                               -> (B, H, hd) fp32

The kernel (``csrc/paged_gqa_decode.cu``) runs one thread block per (KV
head, slot) over 64-token tiles and stops at the tile holding ``qpos``; it
reads rows in 16-byte vectors, so a row of hd values must fill whole
vectors (hd a multiple of 16 for E4M3 pools, 8 for bf16, 4 for fp32).
What bounds it on an H100: the bytes of the resident K/V rows (2·KV·hd + 8
per token per layer, ~8 MB for four slots at contexts 600-1500 at
qwen3-14b's widths), a few microseconds at 3.35 TB/s. KV x B blocks (32
for four slots of qwen3-14b) fill a quarter of the 132 SMs; split-KV is
the lever there too.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import paged
from repro_torch.kernels import build, registry

# the pools the kernels read: E4M3 bytes (page_storage "fp8") or bf16
# ("bf16" storage of a bf16 model); the GQA kernel also reads the fp32
# pools of an fp32 model
_STORAGE_CODE = {torch.uint8: 0, paged.E4M3: 0, torch.bfloat16: 1}
_GQA_STORAGE_CODE = {**_STORAGE_CODE, torch.float32: 2}

paged_mla_decode = registry.op(
    "paged_mla_decode",
    replaces=("src/repro/kernels/paged_attention/paged_attention.py:88 "
              "paged_mla_decode_kernel"))


def _values(pool: torch.Tensor) -> torch.Tensor:
    if pool.dtype in (torch.uint8, paged.E4M3):
        return paged.e4m3_decode(pool)
    return pool.float()


@paged_mla_decode.plain
def paged_mla_decode_plain(q_abs, q_rope, ckv, kr, ckv_s, kr_s, table,
                           qpos, *, scale: float) -> torch.Tensor:
    """Gather + full softmax (``paged_attention/ref.py``). q_abs (B,H,R),
    q_rope (B,H,Rr) fp32; ckv/kr (P+1, page, R/Rr) E4M3 bytes or native
    with per-token scales (P+1, page); table (B, pp); qpos (B,)."""
    B, pp = table.shape
    page = ckv.shape[1]
    ckv_f = _values(ckv) * ckv_s[..., None]
    kr_f = _values(kr) * kr_s[..., None]
    ckv_t = ckv_f[table.long()].reshape(B, pp * page, -1)
    kr_t = kr_f[table.long()].reshape(B, pp * page, -1)
    s = (torch.einsum("bhr,btr->bht", q_abs.float(), ckv_t)
         + torch.einsum("bhr,btr->bht", q_rope.float(), kr_t)) * scale
    valid = (torch.arange(pp * page, device=q_abs.device)[None, :]
             <= qpos[:, None])
    s = s.masked_fill(~valid[:, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,btr->bhr", p, ckv_t)


@functools.cache
def _entry():
    v = ctypes.c_void_p
    i = ctypes.c_int
    return build.entry("paged_mla_decode", "paged_mla_decode",
                       [v, v, v, v, v, v, v, v, v, i, i, i, i, i, i,
                        ctypes.c_float, i, v])


@paged_mla_decode.cuda
def _paged_mla_decode_cuda(q_abs, q_rope, ckv, kr, ckv_s, kr_s, table,
                           qpos, *, scale: float) -> torch.Tensor:
    B, H, R = q_abs.shape
    Rr = q_rope.shape[-1]
    P1, page = ckv.shape[:2]
    pp = table.shape[1]
    code = _STORAGE_CODE.get(ckv.dtype)
    if code is None or kr.dtype != ckv.dtype:
        raise TypeError(f"paged_mla_decode: pools must be E4M3 bytes or "
                        f"bf16 alike, got {ckv.dtype}/{kr.dtype}")
    if ckv.shape != (P1, page, R) or kr.shape != (P1, page, Rr):
        raise ValueError(f"paged_mla_decode: pool shapes {tuple(ckv.shape)}"
                         f", {tuple(kr.shape)} do not match q ({R}, {Rr})")
    if ckv_s.shape != (P1, page) or kr_s.shape != (P1, page):
        raise ValueError("paged_mla_decode: scales must be (P+1, page)")
    args = [q_abs.float(), q_rope.float(), ckv, kr, ckv_s.float(),
            kr_s.float(), table.int(), qpos.int()]
    if not all(t.is_cuda for t in args):
        raise TypeError("paged_mla_decode: every operand must be on the card")
    args = [t.contiguous() for t in args]
    out = torch.empty((B, H, R), dtype=torch.float32, device=q_abs.device)
    P = registry.ptr
    paged_mla_decode.launch(_entry(), *(P(t) for t in args), P(out),
                            B, H, R, Rr, page, pp, ctypes.c_float(scale),
                            code, registry.stream_ptr(out))
    return out


# --- paged GQA decode -----------------------------------------------------------

paged_gqa_decode = registry.op(
    "paged_gqa_decode",
    replaces=("src/repro/kernels/paged_attention/paged_attention.py:171 "
              "paged_gqa_decode_kernel"))

# the kernel keeps a group's G queries and accumulators in shared memory
GQA_MAX_GROUP = 16
GQA_MAX_HEAD_DIM = 256


@paged_gqa_decode.plain
def paged_gqa_decode_plain(q, k, v, k_s, v_s, table, qpos, *,
                           scale: float) -> torch.Tensor:
    """Gather + full softmax (``paged_attention/ref.py``). q (B,H,hd)
    fp32; k/v (P+1, page, KV, hd) E4M3 bytes with per-token scales (P+1,
    page), or native with such scales or ``None`` for unit scales; table
    (B, pp); qpos (B,). Heads factor as (KV, G)."""
    _check_gqa_scales(k, k_s, v_s)
    B, H, hd = q.shape
    page, KV = k.shape[1], k.shape[2]
    G = H // KV
    pp = table.shape[1]
    kf, vf = _values(k), _values(v)
    if k_s is not None:
        kf = kf * k_s[..., None, None]
        vf = vf * v_s[..., None, None]
    kt = kf[table.long()].reshape(B, pp * page, KV, hd)
    vt = vf[table.long()].reshape(B, pp * page, KV, hd)
    qg = q.float().reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qg, kt) * scale
    valid = (torch.arange(pp * page, device=q.device)[None, :]
             <= qpos[:, None])
    s = s.masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkh->bkgh", p, vt).reshape(B, H, hd)


def _check_gqa_scales(k, k_s, v_s) -> None:
    if (k_s is None) != (v_s is None):
        raise ValueError("paged_gqa_decode: pass both scales or neither")
    if k_s is None and k.dtype in (torch.uint8, paged.E4M3):
        raise ValueError("paged_gqa_decode: E4M3 pools need their scales")


@functools.cache
def _gqa_entry():
    v = ctypes.c_void_p
    i = ctypes.c_int
    return build.entry("paged_gqa_decode", "paged_gqa_decode",
                       [v, v, v, v, v, v, v, v, i, i, i, i, i, i,
                        ctypes.c_float, i, v])


@paged_gqa_decode.cuda
def _paged_gqa_decode_cuda(q, k, v, k_s, v_s, table, qpos, *,
                           scale: float) -> torch.Tensor:
    B, H, hd = q.shape
    P1, page, KV = k.shape[:3]
    pp = table.shape[1]
    code = _GQA_STORAGE_CODE.get(k.dtype)
    if code is None or v.dtype != k.dtype:
        raise TypeError(f"paged_gqa_decode: pools must be E4M3 bytes, bf16 "
                        f"or fp32 alike, got {k.dtype}/{v.dtype}")
    if k.shape != (P1, page, KV, hd) or v.shape != k.shape:
        raise ValueError(f"paged_gqa_decode: pool shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q (hd={hd})")
    if H % KV or H // KV > GQA_MAX_GROUP or hd > GQA_MAX_HEAD_DIM:
        raise ValueError(f"paged_gqa_decode: H={H} over KV={KV} heads, "
                         f"hd={hd}: the kernel takes groups of at most "
                         f"{GQA_MAX_GROUP} heads and hd <= {GQA_MAX_HEAD_DIM}")
    if (hd * k.element_size()) % 16:
        raise ValueError(f"paged_gqa_decode: a row of hd={hd} {k.dtype} "
                         "values must fill whole 16-byte vectors")
    _check_gqa_scales(k, k_s, v_s)
    scales = [] if k_s is None else [k_s.float(), v_s.float()]
    if any(s.shape != (P1, page) for s in scales):
        raise ValueError("paged_gqa_decode: scales must be (P+1, page)")
    if k.dtype == paged.E4M3:
        k, v = k.view(torch.uint8), v.view(torch.uint8)
    args = [q.float(), k, v, *scales, table.int(), qpos.int()]
    if not all(t.is_cuda for t in args):
        raise TypeError("paged_gqa_decode: every operand must be on the card")
    args = [registry.contiguous16(t) for t in args]
    if k_s is None:                     # null scale pointers: unit scales
        args[3:3] = [None, None]
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    P = registry.ptr
    paged_gqa_decode.launch(_gqa_entry(), *(P(t) for t in args), P(out),
                            B, H, KV, hd, page, pp, ctypes.c_float(scale),
                            code, registry.stream_ptr(out))
    return out
