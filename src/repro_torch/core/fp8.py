"""FP8 fine-grained mixed-precision path (paper §3.1, T4) — port of
``repro.core.fp8``.

* activations: 1x128 tile-wise scales along the contraction dim
* weights:     128x128 block-wise scales
* accumulation: fp32
* gradients:   1x128 tile-wise E4M3 on both backward GEMMs
  (:func:`fp8_linear` is an ``autograd.Function``, the reference's
  ``custom_vjp``)

Quantization is bitwise equal to the reference: the same fp32 amax, the
same ``max(amax, 1e-12) / 448`` scale, the same IEEE division and the same
round-to-nearest-even cast to E4M3.

``impl='pallas'`` routes the GEMM through the ``fp8_gemm`` op of
``repro_torch.kernels.registry`` (the CUDA kernel on a card, its plain
version on the CPU); ``impl='ref'`` keeps it inline here.

Serving weights are frozen, so the port quantizes each one once, at load
(:class:`Fp8Weight`, made by ``bridge.prepare_for_serving``), where the
reference re-quantizes per call (``kernels/fp8_gemm/ops.py:33-39``). The
values are the same: block quantization of the same weight. The routed
experts of the kernel path are held the same way (:class:`Fp8Experts`):
their straight-through forward value is exactly ``code x scale``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

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
    at load. ``wq`` is stored K-contiguous (:func:`k_major`: the
    ``(..., d_in, d_out)`` view of a ``(..., d_out, d_in)`` buffer), the
    layout the ``fp8_gemm`` kernel reads. Leading axes (the stacked-layers axis) ride along on all
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


def k_major(q: torch.Tensor) -> torch.Tensor:
    """The same ``(..., K, N)`` values, stored K-contiguous: the transpose
    view of an ``(..., N, K)`` row-major copy (the ``fp8_gemm`` kernel's
    weight layout, and what ``torch._scaled_mm`` takes as its second
    operand)."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def _chunk_swizzle(codes: torch.Tensor) -> torch.Tensor:
    """Swap 16-byte chunk c of row f with chunk c ^ 4(f & 1) in each
    ``(..., BLOCK, BLOCK)`` uint8 code block (an involution: it both lays
    out and restores ``Fp8Experts.wq``)."""
    f = torch.arange(BLOCK, device=codes.device)[:, None]
    c = torch.arange(BLOCK // 16, device=codes.device)[None, :]
    idx = (c ^ ((f & 1) << 2))[..., None].expand(BLOCK, BLOCK // 16, 16)
    t = codes.reshape(*codes.shape[:-1], BLOCK // 16, 16)
    return torch.gather(t, -2, idx.expand_as(t)).reshape(codes.shape)


@dataclasses.dataclass(frozen=True)
class Fp8Experts:
    """Stacked routed-expert weights ``(..., E, D, F)`` held as E4M3 codes
    with fp32 128x128 block scales, made once at load
    (``bridge.prepare_for_serving``). The weight is ``dtype(code x
    scale)``, exactly the forward value of the reference's per-call
    straight-through block qdq (the load checks this bit for bit).

    ``wq`` is the ``moe_gemm`` kernel's layout: ``(..., E, Fp/128, Dp/128,
    128, 128)``, one contiguous 16 KB block per (F block, D block), rows
    f of 128 consecutive d (so one 16-byte read holds 16 d of one output
    column), the 16-byte chunks of odd rows swapped between halves
    (:func:`_chunk_swizzle`); D and F zero-padded to multiples of 128
    (``Dp``, ``Fp``). A negative-zero code is stored as +0, the value
    ``w + (qdq(w) - w)`` gives. ``ws`` is ``(..., E, Dp/128, Fp/128)``
    fp32. ``d_in``, ``d_out`` are D and F before padding. Leading axes
    (layers) ride along; :meth:`layer` slices one off."""
    wq: torch.Tensor
    ws: torch.Tensor
    dtype: torch.dtype
    d_in: int
    d_out: int

    @property
    def shape(self) -> torch.Size:
        return torch.Size((*self.wq.shape[:-4], self.d_in, self.d_out))

    @property
    def nbytes(self) -> int:
        return self.wq.nbytes + self.ws.nbytes

    def layer(self, i: int) -> "Fp8Experts":
        return Fp8Experts(self.wq[i], self.ws[i], self.dtype, self.d_in,
                          self.d_out)

    @classmethod
    def quantize(cls, w: torch.Tensor) -> "Fp8Experts":
        """Block-quantize every ``(D, F)`` matrix of ``w`` (one at a time:
        bounded fp32 temporaries)."""
        D, F = w.shape[-2:]
        KB, FB = -(-D // BLOCK), -(-F // BLOCK)
        lead = w.shape[:-2]
        flat = w.reshape(-1, D, F)
        wq = torch.empty((flat.shape[0], FB, KB, BLOCK, BLOCK),
                         dtype=torch.uint8, device=w.device)
        ws = torch.empty((flat.shape[0], KB, FB), dtype=torch.float32,
                         device=w.device)
        full = torch.zeros((KB * BLOCK, FB * BLOCK), dtype=torch.uint8,
                           device=w.device)
        for i in range(flat.shape[0]):
            q, ws[i] = quantize_blockwise(flat[i])
            u = q.view(torch.uint8)
            full[:D, :F] = u.masked_fill(u == 0x80, 0)
            # (KB, d, FB, f) -> (FB, KB, f, d)
            blocks = full.view(KB, BLOCK, FB, BLOCK).permute(2, 0, 3, 1)
            wq[i] = _chunk_swizzle(blocks)
        return cls(wq.view(E4M3).reshape(*lead, FB, KB, BLOCK, BLOCK),
                   ws.reshape(*lead, KB, FB), w.dtype, D, F)

    def dequant(self) -> torch.Tensor:
        """The ``(..., D, F)`` weight in ``dtype``: each code times its
        block's scale in fp32, rounded once to ``dtype``."""
        q = _chunk_swizzle(self.wq.view(torch.uint8)).view(E4M3)
        q = q.float()                                  # (..., FB, KB, f, d)
        q.mul_(self.ws.transpose(-1, -2)[..., None, None])
        *lead, FB, KB = q.shape[:-2]
        n = len(lead)
        out = torch.empty((*lead, KB * BLOCK, FB * BLOCK), dtype=self.dtype,
                          device=q.device)
        out.view(*lead, KB, BLOCK, FB, BLOCK).copy_(
            q.permute(*range(n), n + 1, n + 3, n, n + 2))
        return out[..., :self.d_in, :self.d_out]


def _pad_to(x: torch.Tensor, dim: int, mult: int) -> torch.Tensor:
    n = x.shape[dim]
    pad = (-n) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def quantize_tilewise(x: torch.Tensor, tile: int = TILE,
                      amax: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize along the last axis in 1 x ``tile`` groups.

    Returns ``(q, scale)``: q (E4M3) of x's shape, scale fp32 of shape
    ``x.shape[:-1] + (ceil(d/tile),)``. ``amax`` (that shape) overrides
    each tile's own: a tensor-parallel rank holding part of a tile
    quantizes with the whole tile's amax, taken over the ranks."""
    d = x.shape[-1]
    xp = _pad_to(x.float(), -1, tile)
    t = xp.reshape(*xp.shape[:-1], -1, tile)
    if amax is None:
        amax = t.abs().amax(dim=-1, keepdim=True)
    else:
        amax = amax.float()[..., None]
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
    """The reference's straight-through quant-dequant, ``x + stop_grad(
    qdq(x) - x)``: the forward value evaluated literally in x's dtype (in
    bf16 the two roundings can differ from ``qdq(x)`` alone), the gradient
    the identity."""
    with torch.no_grad():
        d = qdq(x) - x
    return x + d


def scaled_matmul_ref(xq, xs, wq, ws, tile: int = TILE) -> torch.Tensor:
    """Oracle: dequantize both operands, then an fp32 GEMM — the same
    value as per-tile scaled accumulation, since scales are constant
    within each K=128 group. xq (..., d) E4M3, xs (..., d/tile) fp32,
    wq (d, f) E4M3, ws (d/128, f/128) fp32."""
    x = dequant_tilewise(xq, xs, tile)
    w = dequant_blockwise(wq, ws)
    return torch.matmul(x, w)


def matmul_qdq(x: torch.Tensor, w: Union[torch.Tensor, Fp8Weight],
               impl: str, x_amax: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """y = Q(x) @ Q(w) with fine-grained scales, fp32 accumulation, in
    fp32. ``x_amax``: the tile amaxes to quantize x with (see
    :func:`quantize_tilewise`)."""
    if impl == "pallas":
        from repro_torch.kernels.fp8_gemm import ops as fp8_ops
        shape = x.shape
        y = fp8_ops.fp8_matmul(
            x.reshape(-1, shape[-1]), w,
            None if x_amax is None else x_amax.reshape(-1, x_amax.shape[-1]))
        return y.reshape(*shape[:-1], y.shape[-1])
    wq, ws = ((w.wq, w.ws) if isinstance(w, Fp8Weight)
              else quantize_blockwise(w))
    xq, xs = quantize_tilewise(x, amax=x_amax)
    return scaled_matmul_ref(xq, xs, wq, ws)


class _Fp8Linear(torch.autograd.Function):
    """``y = Q(x) @ Q(w)`` with the reference's backward
    (``_fp8_linear_bwd``): ``dx = Q_tile(g) @ Q_block(wᵀ)`` and ``dw =
    Q_tile(x2ᵀ) @ Q_block(g2)``, x2 and g2 the token-flattened x and g
    (the dw tiles run along the tokens). With ``impl="pallas"`` on a CUDA
    tensor all three products are ``fp8_gemm`` launches
    (``kernels/fp8_gemm/ops.fp8_matmul``); otherwise they are
    ``scaled_matmul_ref``, as in the reference. ``x_amax`` (the tile
    amaxes a tensor-parallel rank quantizes its slice of the contraction
    with) and the scales carry no gradient, as in the reference's
    ``custom_vjp``; ``out_fp32`` keeps the fp32 product (a row-parallel
    partial, summed before its rounding)."""

    @staticmethod
    def forward(ctx, x, w, impl, x_amax=None, out_fp32=False):
        ctx.impl = impl
        ctx.save_for_backward(x, w)
        y = matmul_qdq(x, w, impl, x_amax)
        return y if out_fp32 else y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf = g.float()
        g2 = gf.reshape(-1, gf.shape[-1])
        dx = dw = None
        if ctx.impl == "pallas" and g.is_cuda:
            from repro_torch.kernels.fp8_gemm import ops as fp8_ops
            mm = fp8_ops.fp8_matmul
        else:
            def mm(a, b):
                aq, as_ = quantize_tilewise(a)
                bq, bs = quantize_blockwise(b)
                return scaled_matmul_ref(aq, as_, bq, bs)
        if ctx.needs_input_grad[0]:
            dx = mm(g2, w.t()).reshape(*g.shape[:-1], w.shape[0])
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            x2 = x.reshape(-1, x.shape[-1]).float()
            dw = mm(x2.t(), g2).to(w.dtype)
        return dx, dw, None, None, None


def fp8_linear(x: torch.Tensor, w: Union[torch.Tensor, Fp8Weight],
               impl: str = "ref", x_amax: Optional[torch.Tensor] = None,
               out_fp32: bool = False) -> torch.Tensor:
    """FP8-path linear: forward and both backward GEMMs quantized (paper
    recipe). x: (..., d) bf16/f32, w: (d, f) or its :class:`Fp8Weight`
    (serving: frozen, no backward). Returns (..., f) in x.dtype (fp32
    with ``out_fp32``). ``x_amax``: as :func:`matmul_qdq`'s (detached)."""
    if x_amax is not None:
        x_amax = x_amax.detach()
    if isinstance(w, Fp8Weight) or not torch.is_grad_enabled():
        y = matmul_qdq(x, w, impl, x_amax)
        return y if out_fp32 else y.to(x.dtype)
    return _Fp8Linear.apply(x, w, impl, x_amax, out_fp32)
