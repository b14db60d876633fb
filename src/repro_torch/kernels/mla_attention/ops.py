"""Dense-ring MLA absorbed decode: the ``mla_decode`` op, its plain
version and its CUDA launcher.

Replaces the TPU kernel ``src/repro/kernels/mla_attention/
mla_attention.py`` (``mla_decode_kernel``, :72; ``pallas_call`` at :83).
Per slot it streams the slot's latent ring ``ckv (T, R)``, ``kr (T, Rr)``
and folds each row into an online softmax:

    s = (q_abs·ckvᵀ + q_rope·krᵀ)·scale,
    valid iff pos >= 0 and pos <= qpos,
    o = Σ softmax(s)·ckv                       -> (B, H, R) fp32

Validity comes from ``pos`` (-1 = empty), not from the row index: the
ring is written at ``position % T``, so valid rows sit anywhere in it.
A slot with no valid row comes out zero, as the Pallas kernel's does
(``acc / max(l, 1e-30)`` with ``acc = l = 0``), not the uniform mix of
``mla_attention/ref.py``.

The kernel (``csrc/mla_decode.cu``) is ``paged_mla_decode``'s split-KV
design with the ring as its row source (the split pass is shared,
``csrc/mla_split.cuh``): a CTA per (split of ``rps`` ring rows, 16 heads,
slot) keeps the rows of its split whose ``pos`` is valid, in ascending
order, copies only those (``cp.async``) and folds them into an online
softmax with register-blocked fp32 scores and P·V; a combine pass merges
the partial softmaxes over all splits, skipping splits without a valid
row. One counted launch runs both. :func:`ring_split_plan` picks ``rps``
and the number of splits from the shapes and the SM count alone, so the
call reads neither ``pos`` nor ``qpos`` on the host and captures in a
CUDA graph. Rows are copied in 16-byte pieces, so a row of R (and of Rr)
values must fill whole 16-byte vectors: R, Rr multiples of 4 for fp32
caches, of 8 for bf16; R is at most 512 (a thread owns four of the
accumulator's columns).

What bounds it on an H100: the fp32 arithmetic on the CUDA cores,
2·H·(2R + Rr) flops per valid row, over the bytes of the row (R + Rr
values, 2 or 4 bytes each). At four slots of DeepSeek-V3 (H = 128) with
full rings of 1024 that is 1.14 GFLOP against 4.7 MB of bf16 rows:
0.017 ms at the fp32 peak. The plan gives 64-row splits there, 512 CTAs
over the 132 SMs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build, registry
from repro_torch.kernels.paged_attention.ops import (MLA_HEADS_PER_CTA,
                                                     MLA_MAX_RANK, split_plan,
                                                     workspace_floats)

# the ring caches the kernel reads: the model's cache dtype at smoke width
# (fp32) and at published width (bf16)
_CACHE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the split kernel's tile: a split is a whole number of 32-row tiles
RING_TILE = 32

mla_decode = registry.op(
    "mla_decode",
    replaces=("src/repro/kernels/mla_attention/mla_attention.py:72 "
              "mla_decode_kernel"))


@mla_decode.plain
def mla_decode_plain(q_abs, q_rope, ckv, kr, pos, qpos, *,
                     scale: float) -> torch.Tensor:
    """Full softmax (``mla_attention/ref.py``), with rows that have no
    valid key set to zero as the kernel leaves them. q_abs (B,H,R), q_rope
    (B,H,Rr) fp32; ckv (B,T,R), kr (B,T,Rr); pos (B,T) int32 (-1 empty);
    qpos (B,)."""
    ckv_f, kr_f = ckv.float(), kr.float()
    s = (torch.einsum("bhr,btr->bht", q_abs.float(), ckv_f)
         + torch.einsum("bhr,btr->bht", q_rope.float(), kr_f)) * scale
    valid = (pos >= 0) & (pos <= qpos[:, None])
    s = s.masked_fill(~valid[:, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bht,btr->bhr", p, ckv_f)
    return o * valid.any(dim=1).to(o.dtype)[:, None, None]


def ring_split_plan(B: int, H: int, T: int, sms: int) -> Tuple[int, int]:
    """(rows per split, splits) of ``mla_decode`` for ``B`` rings of ``T``
    rows and ``H`` heads on a card of ``sms`` SMs: ``split_plan`` with the
    32-row tile as the page, over ``T`` rounded up to whole tiles (T = 40
    is one split of 64 rows). Shapes only: never reads pos or qpos."""
    tiles = -(-T // RING_TILE) * RING_TILE
    return split_plan(B, -(-H // MLA_HEADS_PER_CTA), tiles, RING_TILE, sms)


@functools.cache
def _entry():
    v = ctypes.c_void_p
    i = ctypes.c_int
    return build.entry("mla_decode", "mla_decode",
                       [v, v, v, v, v, v, v, v, i, i, i, i, i, i, i,
                        ctypes.c_float, i, v])


@mla_decode.cuda
def _mla_decode_cuda(q_abs, q_rope, ckv, kr, pos, qpos, *,
                     scale: float) -> torch.Tensor:
    B, H, R = q_abs.shape
    Rr = q_rope.shape[-1]
    T = ckv.shape[1]
    code = _CACHE_CODE.get(ckv.dtype)
    if code is None or kr.dtype != ckv.dtype:
        raise TypeError(f"mla_decode: caches must be fp32 or bf16 alike, "
                        f"got {ckv.dtype}/{kr.dtype}")
    if (ckv.shape != (B, T, R) or kr.shape != (B, T, Rr)
            or pos.shape != (B, T) or qpos.shape != (B,)):
        raise ValueError(f"mla_decode: shapes ckv {tuple(ckv.shape)}, kr "
                         f"{tuple(kr.shape)}, pos {tuple(pos.shape)}, qpos "
                         f"{tuple(qpos.shape)} do not match q ({B}, {H}, "
                         f"{R}/{Rr})")
    if (R * ckv.element_size()) % 16 or (Rr * kr.element_size()) % 16:
        raise ValueError(f"mla_decode: rows of R={R} and Rr={Rr} "
                         f"{ckv.dtype} values must fill whole 16-byte "
                         "vectors")
    if R > MLA_MAX_RANK:
        raise ValueError(f"mla_decode: the kernel takes R up to "
                         f"{MLA_MAX_RANK}, got R={R}")
    args = [q_abs.float(), q_rope.float(), ckv, kr, pos.int(), qpos.int()]
    if not all(t.is_cuda for t in args):
        raise TypeError("mla_decode: every operand must be on the card")
    args = [registry.contiguous16(t) for t in args]
    rps, S = ring_split_plan(B, H, T, registry.sm_count(q_abs.device))
    ws = torch.empty(workspace_floats(B, H, S, R), dtype=torch.float32,
                     device=q_abs.device)
    out = torch.empty((B, H, R), dtype=torch.float32, device=q_abs.device)
    P = registry.ptr
    mla_decode.launch(_entry(), *(P(t) for t in args), P(out), P(ws),
                      B, H, R, Rr, T, rps, S, ctypes.c_float(scale), code,
                      registry.stream_ptr(out))
    return out
