"""Grouped expert GEMM: op, plain version and CUDA launcher.

Replaces the TPU kernel ``src/repro/kernels/moe_gemm/moe_gemm.py``
(``moe_gemm``, :35; ``pallas_call`` at :44):

    y[e] = x[e] @ w[e]     x (E,C,D), w (E,D,F) -> y (E,C,F) in x's dtype,
                           fp32 accumulation

``w`` comes in one of two formats: a ``(E, D, F)`` tensor, or a
``core.fp8.Fp8Experts`` — E4M3 codes with fp32 128x128 block scales, made
once at load for the FP8 path's routed experts, whose weight is
``dtype(code x scale)``. Both are the same function on the same weight
values; the container moves 1 byte a weight instead of 2.

What bounds it on an H100: bytes, at every shape the main path gives it.
At decode C = 8 rows per expert (``core/moe.capacity``), ~16 flops per
bf16 weight byte against the card's ~295; at the 1024-token prefill
bucket C = 40, still under the ridge. Each call streams the whole expert
wall once: 256 x 7168 x 2048 weights, 7.5 GB in bf16, 3.8 GB as codes.

The kernel (``csrc/moe_gemm.cu``): persistent CTAs walk the (expert,
128-wide F tile) list; a producer warp keeps up to 8 stages in flight with
bulk (TMA) copies on mbarriers — each tile's weights (one contiguous
128x128 code block, or 64x128 bf16), its x rows and its block scale — and
eight consumer warps multiply. A CTA holds all C rows of its tile, so each
weight is read from HBM once. The weight is the 16-row operand of
``mma.sync.m16n8k16`` (y^T = w^T x^T), so C fills N in steps of 8 and
decode pads nothing. Codes are dequantized in registers to the exact bf16
weight (fp16 unpack, fp32 multiply by the block scale, one rounding to
bf16), then multiplied in bf16 with fp32 accumulation. The wrapper pads D
(to 64 for bf16; codes are padded at load) and F (to 128) where they are
ragged; main-path shapes need no copy.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from repro_torch.core import fp8
from repro_torch.kernels import build, registry

BLOCK = fp8.BLOCK   # E4M3 stage depth = the scale block; F tile width
BK_BF16 = 64        # bf16 stage depth (16 KB of weights, as a code stage)

grouped_matmul = registry.op(
    "moe_gemm", replaces="src/repro/kernels/moe_gemm/moe_gemm.py:35 moe_gemm")

Weight = Union[torch.Tensor, fp8.Fp8Experts]


@grouped_matmul.plain
def grouped_matmul_plain(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """fp32 grouped product, cast to x's dtype (``moe_gemm/ref.py``); a
    container is dequantized first (the same weight values)."""
    if isinstance(w, fp8.Fp8Experts):
        w = w.dequant()
    y = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    return y.to(x.dtype)


@functools.cache
def _entry():
    v = ctypes.c_void_p
    i = ctypes.c_int
    return build.entry("moe_gemm", "moe_gemm",
                       [v, v, v, v, i, i, i, i, i, v])


def _check_experts(x: torch.Tensor, w: fp8.Fp8Experts) -> None:
    if w.dtype != torch.bfloat16:
        raise TypeError(f"moe_gemm: the CUDA kernel takes bf16 weights, got "
                        f"a container of {w.dtype} weights")
    if w.wq.dtype != fp8.E4M3 or w.ws.dtype != torch.float32:
        raise TypeError(f"moe_gemm: codes must be E4M3 and scales fp32, got "
                        f"{w.wq.dtype} and {w.ws.dtype}")
    E, C, D = x.shape
    KB, FB = -(-D // BLOCK), -(-w.d_out // BLOCK)
    if w.wq.dim() != 5 or w.wq.shape[0] != E or w.d_in != D:
        raise ValueError(f"moe_gemm: activations {tuple(x.shape)} and "
                         f"codes {tuple(w.wq.shape)} (one layer's experts, "
                         f"d_in {w.d_in}) do not chain")
    if tuple(w.wq.shape[1:]) != (FB, KB, BLOCK, BLOCK):
        raise ValueError(f"moe_gemm: codes {tuple(w.wq.shape)} are not "
                         f"({w.d_in}, {w.d_out}) in {BLOCK}x{BLOCK} blocks")
    if tuple(w.ws.shape) != (E, KB, FB):
        raise ValueError(f"moe_gemm: scales {tuple(w.ws.shape)} do not "
                         f"match codes {tuple(w.wq.shape)}: want "
                         f"{(E, KB, FB)}")
    if not (w.wq.is_contiguous() and w.ws.is_contiguous()):
        raise ValueError("moe_gemm: codes and scales must be contiguous")


@grouped_matmul.cuda
def _grouped_matmul_cuda(x: torch.Tensor, w: Weight) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"moe_gemm: the CUDA kernel takes bf16 activations, "
                        f"got {x.dtype}")
    pad = registry.pad_to_multiple
    E, C, D = x.shape
    if isinstance(w, fp8.Fp8Experts):
        _check_experts(x, w)
        F = w.d_out
        xp = pad(x, 2, BLOCK)
        wp, ws, fmt = w.wq, w.ws, 1
        Fp = w.wq.shape[1] * BLOCK
    else:
        if w.dtype != torch.bfloat16:
            raise TypeError(f"moe_gemm: the CUDA kernel takes bf16 weights, "
                            f"got {w.dtype}")
        if w.dim() != 3 or w.shape[:2] != (E, D):
            raise ValueError(f"moe_gemm: shapes {tuple(x.shape)} x "
                             f"{tuple(w.shape)} do not chain")
        F = w.shape[2]
        xp = pad(x, 2, BK_BF16)
        wp, ws, fmt = pad(pad(w, 1, BK_BF16), 2, BLOCK), None, 0
        Fp = wp.shape[2]
    if not (xp.is_cuda and wp.is_cuda):
        raise TypeError("moe_gemm: both operands must be on the card")
    xp, wp = registry.contiguous16(xp), registry.contiguous16(wp)
    Dp = xp.shape[2]
    y = torch.empty((E, C, Fp), dtype=x.dtype, device=x.device)
    if y.numel():
        P = registry.ptr
        grouped_matmul.launch(_entry(), P(xp), P(wp), P(ws), P(y), E, C, Dp,
                              Fp, fmt, registry.stream_ptr(y))
    return y[:, :, :F]
