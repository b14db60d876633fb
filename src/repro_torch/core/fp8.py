"""FP8 fine-grained mixed-precision path (paper §3.1, T4) — port of
``repro.core.fp8`` (forward only; the backward GEMMs come with training).

* activations: 1x128 tile-wise scales along the contraction dim
* weights:     128x128 block-wise scales
* accumulation: fp32

Quantization is bitwise equal to the reference: the same fp32 amax, the
same ``max(amax, 1e-12) / 448`` scale, the same IEEE division and the same
round-to-nearest-even cast to E4M3.

``impl='pallas'`` routes the GEMM through the ``fp8_gemm`` op of
``repro_torch.kernels.registry`` (the CUDA kernel on a card, its plain
version on the CPU); ``impl='ref'`` keeps it inline here.

Serving weights are frozen, so the port quantizes each one once, at load
(:class:`Fp8Weight`, made by ``bridge.prepare_for_serving``), where the
reference re-quantizes per call (``kernels/fp8_gemm/ops.py:33-39``). The
values are the same: block quantization of the same weight.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

E4M3 = torch.float8_e4m3fn
E4M3_MAX = 448.0

TILE = 128   # paper's 1x128 activation tiles
BLOCK = 128  # paper's 128x128 weight blocks


@dataclasses.dataclass(frozen=True)
class Fp8Weight:
    """A frozen ``(d_in, d_out)`` weight with its block quantization.

    ``w`` is the weight as stored; ``wq`` its E4M3 values and ``ws`` the
    fp32 scale of each 128x128 block (``quantize_blockwise(w)``), made once
    at load. Leading axes (the stacked-layers axis) ride along on all
    three; :meth:`layer` slices one off."""
    w: torch.Tensor
    wq: torch.Tensor
    ws: torch.Tensor

    @property
    def ndim(self) -> int:
        return self.w.ndim

    @property
    def shape(self) -> torch.Size:
        return self.w.shape

    def layer(self, i: int) -> "Fp8Weight":
        return Fp8Weight(self.w[i], self.wq[i], self.ws[i])


def _pad_to(x: torch.Tensor, dim: int, mult: int) -> torch.Tensor:
    n = x.shape[dim]
    pad = (-n) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def quantize_tilewise(x: torch.Tensor, tile: int = TILE
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize along the last axis in 1 x ``tile`` groups.

    Returns ``(q, scale)``: q (E4M3) of x's shape, scale fp32 of shape
    ``x.shape[:-1] + (ceil(d/tile),)``."""
    d = x.shape[-1]
    xp = _pad_to(x.float(), -1, tile)
    t = xp.reshape(*xp.shape[:-1], -1, tile)
    amax = t.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-12) / E4M3_MAX
    q = (t / scale).to(E4M3)
    q = q.reshape(xp.shape)[..., :d]
    return q, scale[..., 0]


def quantize_blockwise(w: torch.Tensor, block: int = BLOCK
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a ``(..., m, n)`` weight in ``block`` x ``block`` squares
    (leading axes are independent weights, as the reference's vmap).

    Returns ``(q (..., m, n), scale (..., ceil(m/b), ceil(n/b)) fp32)``."""
    m, n = w.shape[-2:]
    wp = _pad_to(_pad_to(w.float(), -2, block), -1, block)
    M, N = wp.shape[-2:]
    lead = wp.shape[:-2]
    t = wp.reshape(*lead, M // block, block, N // block, block)
    amax = t.abs().amax(dim=(-3, -1), keepdim=True)
    scale = amax.clamp_min(1e-12) / E4M3_MAX
    q = (t / scale).to(E4M3).reshape(*lead, M, N)[..., :m, :n]
    return q, scale[..., :, 0, :, 0]


def dequant_tilewise(q: torch.Tensor, scale: torch.Tensor,
                     tile: int = TILE) -> torch.Tensor:
    d = q.shape[-1]
    qp = _pad_to(q.float(), -1, tile)
    t = qp.reshape(*qp.shape[:-1], -1, tile) * scale[..., None]
    return t.reshape(qp.shape)[..., :d]


def dequant_blockwise(q: torch.Tensor, scale: torch.Tensor,
                      block: int = BLOCK) -> torch.Tensor:
    m, n = q.shape[-2:]
    qp = _pad_to(_pad_to(q.float(), -2, block), -1, block)
    M, N = qp.shape[-2:]
    lead = qp.shape[:-2]
    t = qp.reshape(*lead, M // block, block, N // block, block)
    t = t * scale[..., :, None, :, None]
    return t.reshape(*lead, M, N)[..., :m, :n]


def qdq_tile(x: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    q, s = quantize_tilewise(x, tile)
    return dequant_tilewise(q, s, tile).to(x.dtype)


def qdq_block(w: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    q, s = quantize_blockwise(w, block)
    return dequant_blockwise(q, s, block).to(w.dtype)


def ste_qdq(x: torch.Tensor, qdq) -> torch.Tensor:
    """Forward value of the reference's straight-through quant-dequant,
    ``x + (qdq(x) - x)``, evaluated literally in x's dtype (in bf16 the two
    roundings can differ from ``qdq(x)`` alone)."""
    return x + (qdq(x) - x)


def scaled_matmul_ref(xq, xs, wq, ws, tile: int = TILE) -> torch.Tensor:
    """Oracle: dequantize both operands, then an fp32 GEMM — the same
    value as per-tile scaled accumulation, since scales are constant
    within each K=128 group. xq (..., d) E4M3, xs (..., d/tile) fp32,
    wq (d, f) E4M3, ws (d/128, f/128) fp32."""
    x = dequant_tilewise(xq, xs, tile)
    w = dequant_blockwise(wq, ws)
    return torch.matmul(x, w)


def _matmul_qdq(x: torch.Tensor, w: Union[torch.Tensor, Fp8Weight],
                impl: str) -> torch.Tensor:
    """y = Q(x) @ Q(w) with fine-grained scales, fp32 accumulation."""
    if impl == "pallas":
        from repro_torch.kernels.fp8_gemm import ops as fp8_ops
        shape = x.shape
        y = fp8_ops.fp8_matmul(x.reshape(-1, shape[-1]), w)
        return y.reshape(*shape[:-1], y.shape[-1])
    wq, ws = ((w.wq, w.ws) if isinstance(w, Fp8Weight)
              else quantize_blockwise(w))
    xq, xs = quantize_tilewise(x)
    return scaled_matmul_ref(xq, xs, wq, ws)


def fp8_linear(x: torch.Tensor, w: Union[torch.Tensor, Fp8Weight],
               impl: str = "ref") -> torch.Tensor:
    """FP8-path linear (forward). x: (..., d) bf16/f32, w: (d, f) or its
    :class:`Fp8Weight`. Returns (..., f) in x.dtype."""
    return _matmul_qdq(x, w, impl).to(x.dtype)
