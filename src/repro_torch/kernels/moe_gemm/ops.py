"""Grouped expert GEMM: op, plain version and CUDA launcher.

Replaces the TPU kernel ``src/repro/kernels/moe_gemm/moe_gemm.py``
(``moe_gemm``, :35; ``pallas_call`` at :44):

    y[e] = x[e] @ w[e]     x (E,C,D), w (E,D,F) -> y (E,C,F) in x's dtype,
                           fp32 accumulation

The kernel (``csrc/moe_gemm.cu``) runs one thread block per (expert,
128-wide F tile, 16-row C tile) and loops over D in 32-wide steps, with
``mma.sync`` on bf16 operands and fp32 accumulation. A bf16 x bf16 product
is exact in fp32, so this is faithful to the TPU kernel's fp32 upcast; only
the order of the sums differs.

What bounds it on an H100: at decode the capacity buffer has C = 8 rows
per expert (``core/moe.capacity``), so every call streams the whole expert
weight wall (E·D·F·2 bytes) for ~16 flops per weight byte — far below the
card's ~295 flops/byte ridge, so it is bound by bytes over 3.35 TB/s. The
design keeps one pass over w (each weight element is read by exactly one
block) and spreads E·F/128 blocks over the SMs; it does not yet pipeline
its loads (cp.async/TMA), which is where the remaining gap to the bound
is. The wrapper pads C to 16, D to 32 and F to 128; the kernel masks
nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, registry

BM, BN, BK = 16, 128, 32   # kernel tile: C rows, F columns, D depth

grouped_matmul = registry.op(
    "moe_gemm", replaces="src/repro/kernels/moe_gemm/moe_gemm.py:35 moe_gemm")


@grouped_matmul.plain
def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 grouped product, cast to x's dtype (``moe_gemm/ref.py``)."""
    y = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    return y.to(x.dtype)


@functools.cache
def _entry():
    v = ctypes.c_void_p
    i = ctypes.c_int
    return build.entry("moe_gemm", "moe_gemm", [v, v, v, i, i, i, i, v])


@grouped_matmul.cuda
def _grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"moe_gemm: the CUDA kernel takes bf16 operands, "
                        f"got {x.dtype} x {w.dtype}")
    if not (x.is_cuda and w.is_cuda):
        raise TypeError("moe_gemm: both operands must be on the card")
    E, C, D = x.shape
    if w.shape[:2] != (E, D):
        raise ValueError(f"moe_gemm: shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)} do not chain")
    F = w.shape[2]
    pad = registry.pad_to_multiple
    xp = pad(pad(x, 1, BM), 2, BK).contiguous()
    wp = pad(pad(w, 1, BK), 2, BN).contiguous()
    Cp, Dp, Fp = xp.shape[1], xp.shape[2], wp.shape[2]
    y = torch.empty((E, Cp, Fp), dtype=x.dtype, device=x.device)
    P = registry.ptr
    grouped_matmul.launch(_entry(), P(xp), P(wp), P(y), E, Cp, Dp, Fp,
                          registry.stream_ptr(y))
    return y[:, :C, :F]
