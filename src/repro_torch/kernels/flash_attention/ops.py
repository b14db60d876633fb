"""Flash bucketed-prefill attention: op, plain version and CUDA launcher.

Replaces the TPU kernel ``src/repro/kernels/flash_attention/
flash_attention.py`` (``flash_prefill_kernel``, :73; ``pallas_call`` at
:109). Block-tiled masked softmax attention over a power-of-two prefill
bucket:

    s = q·kᵀ·scale over KV head h // G,
    valid iff k_pos >= 0 and (causal => k_pos <= q_pos),
    o = Σ softmax(s)·v, zeros on a row with no valid key
                                             -> (B, S, H, hd) fp32

What bounds it on an H100: causal prefill of a 2048 bucket at qwen3-14b's
40 heads of 128 is 4.3e10 FLOP for ~50 MB of operands and output, so the
bf16 tensor cores bound it: 0.0434 ms at 989 TFLOP/s.

The kernel (``csrc/flash_prefill.cu``) on bf16 operands is built for
Hopper: one persistent CTA per SM walks (128-row query tile, batch, head)
tiles, heaviest first. A producer warp loads each key block's positions,
skips blocks no row of the tile may attend (the upper triangle of causal
prefill; no order of the positions assumed) and feeds Q, K and V by TMA,
read in place through 4-D tensor maps, into a ring of shared-memory
stages. Two consumer warpgroups take turns on the tensor cores: ``wgmma``
for S = Q·Kᵀ, an fp32 online softmax in registers (exp2, the scale folded
in) that runs under the products, then ``wgmma`` for O += P·V with P from
registers and V read in its stored layout. fp32 operands stay fp32 on
the CUDA cores.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, registry

flash_prefill = registry.op(
    "flash_prefill",
    replaces=("src/repro/kernels/flash_attention/flash_attention.py:73 "
              "flash_prefill_kernel"))

# head dims the tensor-core (bf16) path is built for, and the fp32 path's
# limit (its tiles live in shared memory)
BF16_HEAD_DIMS = (32, 64, 128)
F32_MAX_HEAD_DIM = 256


@flash_prefill.plain
def flash_prefill_plain(q, k, v, q_pos, k_pos, *, causal: bool,
                        scale: float) -> torch.Tensor:
    """Full-matrix masked softmax (``flash_attention/ref.py``): q
    (B,S,H,hd); k/v (B,T,KV,hd); q_pos (B,S); k_pos (B,T). Rows with no
    valid key give zeros. Returns (B,S,H,hd) fp32."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, S, KV, G, hd) * scale
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    valid = k_pos[:, None, :] >= 0                       # (B, S?, T)
    if causal:
        valid = valid & (k_pos[:, None, :] <= q_pos[:, :, None])
    s = s.masked_fill(~valid[:, None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    # empty rows (no valid key) emit zeros, matching the kernel
    p = p * valid.any(dim=-1)[:, None, None, :, None]
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return o.reshape(B, S, H, hd)


@functools.cache
def _entry():
    v = ctypes.c_void_p
    i = ctypes.c_int
    return build.entry("flash_prefill", "flash_prefill",
                       [v, v, v, v, v, v, i, i, i, i, i, i, i,
                        ctypes.c_float, i, v])


@flash_prefill.cuda
def _flash_prefill_cuda(q, k, v, q_pos, k_pos, *, causal: bool,
                        scale: float) -> torch.Tensor:
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape != (B, T, KV, hd) or v.shape != k.shape or H % KV:
        raise ValueError(f"flash_prefill: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if q_pos.shape != (B, S) or k_pos.shape != (B, T):
        raise ValueError("flash_prefill: positions must be (B,S) and (B,T)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_prefill: operands differ in dtype: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype == torch.bfloat16:
        code = 0
        if hd not in BF16_HEAD_DIMS:
            raise ValueError(f"flash_prefill: the bf16 kernel takes hd in "
                             f"{BF16_HEAD_DIMS}, got {hd}")
    elif q.dtype == torch.float32:
        code = 1
        if hd > F32_MAX_HEAD_DIM:
            raise ValueError(f"flash_prefill: the fp32 kernel takes hd <= "
                             f"{F32_MAX_HEAD_DIM}, got {hd}")
    else:
        raise TypeError(f"flash_prefill: the CUDA kernel takes bf16 or fp32 "
                        f"operands, got {q.dtype}")
    if not math.isfinite(scale):
        raise ValueError(f"flash_prefill: the scale must be finite, got "
                         f"{scale}")
    if code == 0 and scale < 0:
        # the bf16 kernel folds scale·log2 e into its exp2 and takes
        # scale > 0: q·k·scale = (-q)·k·|scale| exactly (negating bf16 is
        # exact), and scale 0 gives every valid key the same score
        q, scale = -q, -scale
    elif code == 0 and scale == 0:
        q, scale = torch.zeros_like(q), 1.0
    args = [registry.contiguous16(t)
            for t in (q, k, v, q_pos.int(), k_pos.int())]
    if not all(t.is_cuda for t in args):
        raise TypeError("flash_prefill: every operand must be on the card")
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    P = registry.ptr
    flash_prefill.launch(_entry(), *(P(t) for t in args), P(out), B, S, T,
                         H, KV, hd, int(causal), ctypes.c_float(scale), code,
                         registry.stream_ptr(out))
    return out
