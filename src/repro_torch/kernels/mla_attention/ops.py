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

The kernel (``csrc/mla_decode.cu``) runs one thread block per (group of
8 heads, slot) over 32-row tiles of the ring, skips a tile whose ``pos``
holds no valid row (a block-wide vote), and masks a ragged last tile
itself, where the Pallas op pads ``pos`` with -1 to a multiple of its
block. It reads rows as 16-byte vectors, so a row of R (and of Rr)
values must fill whole vectors: R, Rr multiples of 4 for fp32 caches, of
8 for bf16.

What bounds it on an H100: the fp32 arithmetic on the CUDA cores,
2·H·(2R + Rr) flops per valid row, over the bytes of the row (R + Rr
values, 2 or 4 bytes each). At four slots of DeepSeek-V3 (H = 128) that
is 1.14 GFLOP against 6.9 MB: 0.017 ms at the fp32 peak. B·H/8 blocks
(64 at four slots) fill half the 132 SMs; split-KV is the lever there.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, registry

# the ring caches the kernel reads: the model's cache dtype at smoke width
# (fp32) and at published width (bf16)
_CACHE_CODE = {torch.float32: 0, torch.bfloat16: 1}

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


@functools.cache
def _entry():
    v = ctypes.c_void_p
    i = ctypes.c_int
    return build.entry("mla_decode", "mla_decode",
                       [v, v, v, v, v, v, v, i, i, i, i, i,
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
    args = [q_abs.float(), q_rope.float(), ckv, kr, pos.int(), qpos.int()]
    if not all(t.is_cuda for t in args):
        raise TypeError("mla_decode: every operand must be on the card")
    args = [registry.contiguous16(t) for t in args]
    out = torch.empty((B, H, R), dtype=torch.float32, device=q_abs.device)
    P = registry.ptr
    mla_decode.launch(_entry(), *(P(t) for t in args), P(out),
                      B, H, R, Rr, T, ctypes.c_float(scale), code,
                      registry.stream_ptr(out))
    return out
