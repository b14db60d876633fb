"""Paged decode attention: the MLA absorbed and the GQA ops, each with
its plain version and CUDA launcher, and the split plan both kernels run.

``paged_mla_decode``

Replaces the TPU kernel ``src/repro/kernels/paged_attention/
paged_attention.py`` (``paged_mla_decode_kernel``, :88; ``pallas_call``
at :123). Per slot it walks the page table, dequantizes each E4M3 latent
row by its per-token scale, and folds it into an online softmax:

    s = (q_abs·ckvᵀ + q_rope·krᵀ)·scale,  valid iff row <= qpos,
    o = Σ softmax(s)·ckv                       -> (B, H, R) fp32

What bounds it on an H100: fp32 operations. At H = 128 a 584-byte latent
row feeds 128 heads × 2·(2R + Rr) flops, about 480 flops a byte, and
``q_abs`` is genuinely fp32. The kernel (``csrc/paged_mla_decode.cu``)
runs a CTA per (split of rows, 16 heads, slot): one copied row feeds 16
heads, and the scores and P·V are register-blocked fp32 GEMMs on the
CUDA cores over 32-row tiles that asynchronous copies bring in two tiles
ahead.

``paged_gqa_decode``

Replaces ``paged_gqa_decode_kernel`` (same file, :171; ``pallas_call`` at
:218). The head axis factors as (KV, G): query heads ``kv*G .. kv*G+G-1``
share KV head ``kv``. Per slot and KV head it walks the page table,
dequantizes each K/V row by its per-token scale, scores the group's G
heads against it and folds the scores into an online softmax:

    s = q·kᵀ·scale,  valid iff row <= qpos,  o = Σ softmax(s)·v
                                               -> (B, H, hd) fp32

What bounds it on an H100: the bytes of the resident K/V rows (2·KV·hd +
8 per token per layer, ~8.6 MB for four slots at contexts 600-1500 at
qwen3-14b's widths, 2.6 µs at 3.35 TB/s): at G = 5 a row feeds 10 flops
a byte. The kernel (``csrc/paged_gqa_decode.cu``) runs a CTA per (split
of rows, KV head, slot) that copies all of its split's K and V rows at
once with 16-byte asynchronous copies, so many rows are in flight on
every SM; it reads rows in 16-byte vectors, so a row of hd values must fill
whole vectors (hd a multiple of 16 for E4M3 pools, 8 for bf16, 4 for
fp32).

The split plan (split-KV)

Both kernels spread each slot's pages over many CTAs and merge the
partial softmaxes in a second kernel, the combine pass, launched by the
same C entry (one counted launch). :func:`split_plan` picks the rows per
split (a whole number of pages, 64-128 rows) and the number of splits
from the shapes and the card's SM count alone: the grid covers all
``pp·page`` rows of a slot, CTAs whose split starts past the slot's
``qpos`` return at once, and the combine reads ``qpos`` on the card. So
nothing reads ``qpos`` on the host and the launch can be captured in a
CUDA graph. The plan takes the longest split that still gives two CTAs
per SM over the whole grid (half of them active at the main paths'
contexts): qwen3-14b's four slots get 128-row splits, 512 CTAs, 280 of
them active at contexts 600-1500; DeepSeek-V3's get 64-row splits of 16
heads, 512 CTAs, 264 active at contexts 64-1024. The partials (fp32
``m``, ``l`` and the unnormalised accumulator per slot, head and split)
go to a workspace the wrapper allocates with ``torch.empty``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core import paged
from repro_torch.kernels import build, registry

# the pools the kernels read: E4M3 bytes (page_storage "fp8") or bf16
# ("bf16" storage of a bf16 model); the GQA kernel also reads the fp32
# pools of an fp32 model
_STORAGE_CODE = {torch.uint8: 0, paged.E4M3: 0, torch.bfloat16: 1}
_GQA_STORAGE_CODE = {**_STORAGE_CODE, torch.float32: 2}


# --- the split plan ---------------------------------------------------------------

SPLIT_MIN_ROWS = 64
SPLIT_MAX_ROWS = 128
# the MLA kernel's CTA takes 16 heads (csrc/paged_mla_decode.cu, HG)
MLA_HEADS_PER_CTA = 16
# the GQA kernel holds a split's K and V rows in shared memory at once, in
# rows padded to an odd count of 16-byte units; at most this many bytes
GQA_KV_SMEM = 96 * 1024


def split_plan(B: int, units: int, rows: int, page: int, sms: int,
               max_rows: int = SPLIT_MAX_ROWS) -> Tuple[int, int]:
    """(rows per split, splits) for ``B`` slots of ``rows`` = pp·page rows
    each, over ``units`` CTAs per slot and split (KV heads, or groups of
    heads), on a card of ``sms`` SMs. A split is a whole number of pages.
    From ``max_rows`` (rounded down to pages), halve while the whole grid
    is under two CTAs per SM and the half is still a whole number of pages
    of at least ``SPLIT_MIN_ROWS`` rows. Shapes only: never reads qpos."""
    rps = max(page, min(max_rows, rows) // page * page)
    while (B * units * -(-rows // rps) < 2 * sms
           and rps // 2 >= SPLIT_MIN_ROWS and (rps // 2) % page == 0):
        rps //= 2
    return rps, -(-rows // rps)


def gqa_row_stride(hd: int, esize: int) -> int:
    """Bytes of one K or V row in the GQA kernel's shared memory."""
    return ((hd * esize // 16) | 1) * 16


def gqa_split_plan(B: int, KV: int, hd: int, esize: int, page: int,
                   pp: int, sms: int) -> Tuple[int, int]:
    """``split_plan`` for ``paged_gqa_decode``: a CTA per (split, KV head,
    slot), the split's K and V rows within ``GQA_KV_SMEM``."""
    max_rows = min(SPLIT_MAX_ROWS, GQA_KV_SMEM // (2 * gqa_row_stride(
        hd, esize)))
    if max_rows < page:
        raise ValueError(f"paged_gqa_decode: a page of {page} K/V rows of "
                         f"hd={hd} does not fit the kernel's shared memory")
    return split_plan(B, KV, pp * page, page, sms, max_rows)


def mla_split_plan(B: int, H: int, page: int, pp: int,
                   sms: int) -> Tuple[int, int]:
    """``split_plan`` for ``paged_mla_decode``: a CTA per (split, 16 heads,
    slot)."""
    return split_plan(B, -(-H // MLA_HEADS_PER_CTA), pp * page, page, sms)


def workspace_floats(B: int, H: int, splits: int, D: int) -> int:
    """fp32 partials of a split launch: the accumulators (B, H, S, D), then
    m and l (B, H, S) each."""
    return B * H * splits * (D + 2)


def _values(pool: torch.Tensor) -> torch.Tensor:
    if pool.dtype in (torch.uint8, paged.E4M3):
        return paged.e4m3_decode(pool)
    return pool.float()


def _check_scales(name, pool, s1, s2) -> None:
    if (s1 is None) != (s2 is None):
        raise ValueError(f"{name}: pass both scales or neither")
    if s1 is None and pool.dtype in (torch.uint8, paged.E4M3):
        raise ValueError(f"{name}: E4M3 pools need their scales")


def _launch_args(name, tensors, scales, P1, page):
    """The operands on the card, contiguous and 16-byte aligned, with null
    pointers for omitted scales (unit scales)."""
    if any(s.shape != (P1, page) for s in scales):
        raise ValueError(f"{name}: scales must be (P+1, page)")
    args = [*tensors[:-2], *scales, *tensors[-2:]]
    if not all(t.is_cuda for t in args):
        raise TypeError(f"{name}: every operand must be on the card")
    args = [registry.contiguous16(t) for t in args]
    if not scales:
        args[len(tensors) - 2:len(tensors) - 2] = [None, None]
    return args


# --- paged MLA decode -----------------------------------------------------------

paged_mla_decode = registry.op(
    "paged_mla_decode",
    replaces=("src/repro/kernels/paged_attention/paged_attention.py:88 "
              "paged_mla_decode_kernel"))

# a thread of the MLA kernel owns 4 of the accumulator's R columns
MLA_MAX_RANK = 512


@paged_mla_decode.plain
def paged_mla_decode_plain(q_abs, q_rope, ckv, kr, ckv_s, kr_s, table,
                           qpos, *, scale: float) -> torch.Tensor:
    """Gather + full softmax (``paged_attention/ref.py``). q_abs (B,H,R),
    q_rope (B,H,Rr) fp32; ckv/kr (P+1, page, R/Rr) E4M3 bytes with
    per-token scales (P+1, page), or native with such scales or ``None``
    for unit scales; table (B, pp); qpos (B,)."""
    _check_scales("paged_mla_decode", ckv, ckv_s, kr_s)
    B, pp = table.shape
    page = ckv.shape[1]
    ckv_f, kr_f = _values(ckv), _values(kr)
    if ckv_s is not None:
        ckv_f = ckv_f * ckv_s[..., None]
        kr_f = kr_f * kr_s[..., None]
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
                       [v, v, v, v, v, v, v, v, v, v, i, i, i, i, i, i, i, i,
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
    if R % 4 or R > MLA_MAX_RANK or Rr % 4:
        raise ValueError(f"paged_mla_decode: the kernel takes R up to "
                         f"{MLA_MAX_RANK} and R, Rr multiples of 4, got "
                         f"R={R}, Rr={Rr}")
    _check_scales("paged_mla_decode", ckv, ckv_s, kr_s)
    if ckv.dtype == paged.E4M3:
        ckv, kr = ckv.view(torch.uint8), kr.view(torch.uint8)
    scales = [] if ckv_s is None else [ckv_s.float(), kr_s.float()]
    args = _launch_args("paged_mla_decode",
                        [q_abs.float(), q_rope.float(), ckv, kr, table.int(),
                         qpos.int()], scales, P1, page)
    rps, S = mla_split_plan(B, H, page, pp,
                            registry.sm_count(q_abs.device))
    ws = torch.empty(workspace_floats(B, H, S, R), dtype=torch.float32,
                     device=q_abs.device)
    out = torch.empty((B, H, R), dtype=torch.float32, device=q_abs.device)
    P = registry.ptr
    paged_mla_decode.launch(_entry(), *(P(t) for t in args), P(out), P(ws),
                            B, H, R, Rr, page, pp, rps, S,
                            ctypes.c_float(scale), code,
                            registry.stream_ptr(out))
    return out


# --- paged GQA decode -----------------------------------------------------------

paged_gqa_decode = registry.op(
    "paged_gqa_decode",
    replaces=("src/repro/kernels/paged_attention/paged_attention.py:171 "
              "paged_gqa_decode_kernel"))

# the kernel keeps a group's G scores per row in registers and its G
# queries in shared memory
GQA_MAX_GROUP = 16
GQA_MAX_HEAD_DIM = 256


@paged_gqa_decode.plain
def paged_gqa_decode_plain(q, k, v, k_s, v_s, table, qpos, *,
                           scale: float) -> torch.Tensor:
    """Gather + full softmax (``paged_attention/ref.py``). q (B,H,hd)
    fp32; k/v (P+1, page, KV, hd) E4M3 bytes with per-token scales (P+1,
    page), or native with such scales or ``None`` for unit scales; table
    (B, pp); qpos (B,). Heads factor as (KV, G)."""
    _check_scales("paged_gqa_decode", k, k_s, v_s)
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


@functools.cache
def _gqa_entry():
    v = ctypes.c_void_p
    i = ctypes.c_int
    return build.entry("paged_gqa_decode", "paged_gqa_decode",
                       [v, v, v, v, v, v, v, v, v, i, i, i, i, i, i, i, i,
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
    _check_scales("paged_gqa_decode", k, k_s, v_s)
    if k.dtype == paged.E4M3:
        k, v = k.view(torch.uint8), v.view(torch.uint8)
    scales = [] if k_s is None else [k_s.float(), v_s.float()]
    args = _launch_args("paged_gqa_decode",
                        [q.float(), k, v, table.int(), qpos.int()], scales,
                        P1, page)
    rps, S = gqa_split_plan(B, KV, hd, k.element_size(), page, pp,
                            registry.sm_count(q.device))
    ws = torch.empty(workspace_floats(B, H, S, hd), dtype=torch.float32,
                     device=q.device)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    P = registry.ptr
    paged_gqa_decode.launch(_gqa_entry(), *(P(t) for t in args), P(out),
                            P(ws), B, H, KV, hd, page, pp, rps, S,
                            ctypes.c_float(scale), code,
                            registry.stream_ptr(out))
    return out
