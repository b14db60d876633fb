"""Fine-grained-scaled FP8 GEMM: op, plain version and CUDA launcher.

Replaces the TPU kernel ``src/repro/kernels/fp8_gemm/fp8_gemm.py``
(``fp8_gemm``, :49; ``pallas_call`` at :59):

    y = (xq · xs) @ (wq · ws)      xq (M,K) E4M3, xs (M,K/128) fp32 (1x128
                                   tiles); wq (K,N) E4M3, ws (K/128,N/128)
                                   fp32 (128x128 blocks); y (M,N) fp32

The kernel (``csrc/fp8_gemm.cu``) walks K in 128-wide groups: it multiplies
the group's E4M3 tiles, converted exactly to fp16 (E4M3 ⊂ fp16), on the
tensor cores with ``mma.sync`` into a fresh fp32 partial, then scales that
partial by ``xs[m,k]·ws[k,n]`` and adds it into the fp32 accumulator — the
paper's §3.1 promotion of each 128-K partial into full precision.

What bounds it on an H100: at decode (M = a few slots) the weight bytes
(1 per element) over 3.35 TB/s; at prefill (M = the bucket) the tensor-core
rate. This first version is the simple one: 16x128 output tiles per block
of four warps, one K group per shared-memory stage, no pipelining, so it
reaches neither bound; the fast path (FP8 ``wgmma`` fed by TMA) is a later
PR. The wrapper pads M to 16 and K, N to 128 rather than the kernel.

``fp8_matmul(x, w)`` is the caller-facing function: it quantizes x per
1x128 tile (plain tensor code, as in the reference) and takes w either as
a tensor, quantized per call like the reference, or as a
``core.fp8.Fp8Weight`` quantized once at load.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from repro_torch.core import fp8
from repro_torch.kernels import build, registry

BLOCK = 128   # scale granularity (fixed by the format)
BM = 16       # kernel row tile (the wrapper pads M to it)

fp8_gemm = registry.op(
    "fp8_gemm", replaces="src/repro/kernels/fp8_gemm/fp8_gemm.py:49 fp8_gemm")


@fp8_gemm.plain
def fp8_gemm_plain(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                   ws: torch.Tensor) -> torch.Tensor:
    """Dequantize, then an fp32 GEMM (``kernels/fp8_gemm/ref.py``): the
    same value as per-group scaled accumulation. K and N are multiples of
    128 here, as in the reference oracle."""
    M, K = xq.shape
    N = wq.shape[1]
    kb, nb = K // BLOCK, N // BLOCK
    x = (xq.float().reshape(M, kb, BLOCK) * xs[..., None]).reshape(M, K)
    w = wq.float().reshape(kb, BLOCK, nb, BLOCK)
    w = (w * ws[:, None, :, None]).reshape(K, N)
    return torch.matmul(x, w)


@functools.cache
def _entry():
    v = ctypes.c_void_p
    return build.entry("fp8_gemm", "fp8_gemm",
                       [v, v, v, v, v, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, v])


@fp8_gemm.cuda
def _fp8_gemm_cuda(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                   ws: torch.Tensor) -> torch.Tensor:
    M, K = xq.shape
    N = wq.shape[1]
    for t, dt in ((xq, fp8.E4M3), (wq, fp8.E4M3), (xs, torch.float32),
                  (ws, torch.float32)):
        if t.dtype != dt or not t.is_cuda:
            raise TypeError(f"fp8_gemm: expected CUDA {dt}, got {t.dtype} "
                            f"on {t.device}")
    if K % BLOCK or N % BLOCK or wq.shape[0] != K:
        raise ValueError(f"fp8_gemm: K ({K}) and N ({N}) must be multiples "
                         f"of {BLOCK} and agree, got {tuple(xq.shape)} x "
                         f"{tuple(wq.shape)}")
    if xs.shape != (M, K // BLOCK) or ws.shape != (K // BLOCK, N // BLOCK):
        raise ValueError(f"fp8_gemm: scale shapes {tuple(xs.shape)}, "
                         f"{tuple(ws.shape)} do not match {M}x{K}x{N}")
    Mp = -(-M // BM) * BM
    xq = registry.pad_to_multiple(xq.view(torch.uint8), 0, BM).contiguous()
    xs = registry.pad_to_multiple(xs, 0, BM).contiguous()
    wq = wq.view(torch.uint8).contiguous()
    ws = ws.contiguous()
    y = torch.empty((Mp, N), dtype=torch.float32, device=xq.device)
    for t in (xq, wq):
        if t.data_ptr() % 16:
            raise ValueError("fp8_gemm: operands must be 16-byte aligned")
    P = registry.ptr
    fp8_gemm.launch(_entry(), P(xq), P(xs), P(wq), P(ws), P(y), Mp, N, K,
                    registry.stream_ptr(y))
    return y[:M]


def fp8_matmul(x: torch.Tensor,
               w: Union[torch.Tensor, fp8.Fp8Weight]) -> torch.Tensor:
    """y = Q(x) @ Q(w) in fp32. x: (M, K); w: (K, N) or its Fp8Weight."""
    M, N = x.shape[0], w.shape[-1]
    wq, ws = ((w.wq, w.ws) if isinstance(w, fp8.Fp8Weight)
              else fp8.quantize_blockwise(w))
    # K and N to the 128 grid: padding quantizes to zeros, so it changes
    # neither the tile/block scales nor the product
    xq, xs = fp8.quantize_tilewise(x)
    xq = _pad_fp8(xq, 1, BLOCK)
    wq = _pad_fp8(_pad_fp8(wq, 0, BLOCK), 1, BLOCK)
    y = fp8_gemm(xq, xs, wq, ws)
    return y[:M, :N]


def _pad_fp8(q: torch.Tensor, dim: int, mult: int) -> torch.Tensor:
    """Zero-pad an E4M3 tensor (through its bytes: the byte 0 is +0.0)."""
    return registry.pad_to_multiple(q.view(torch.uint8), dim,
                                    mult).view(fp8.E4M3)
