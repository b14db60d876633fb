"""Paged MLA absorbed decode: op, plain version and CUDA launcher.

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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import paged
from repro_torch.kernels import build, registry

# the pools the kernel reads: E4M3 bytes (page_storage "fp8") or bf16
# ("bf16" storage of a bf16 model)
_STORAGE_CODE = {torch.uint8: 0, paged.E4M3: 0, torch.bfloat16: 1}

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
