"""LogFMT-nBit: logarithmic block floating-point format (paper §3.2, T5) —
port of ``repro.core.logfmt``.

Per 1x128 tile of activations:
  * take logs of |x|; min/max over the tile define a per-tile dynamic range
  * the range is clamped to ``max - log(2^32)`` (≈ E5 exponent coverage)
  * n-bit code: 1 sign bit + (n-1)-bit index K on a uniform log-space grid
      code 0        -> zero: 0, NaN, or a subnormal (|x| < 2^-126, which
                       the reference's platforms flush to zero)
      code K>=1     -> sign * exp(min + Step*(K-1)),
      Step = (max-min) / (2^(n-1) - 2)
  * rounding happens in the ORIGINAL LINEAR space: between the two
    bracketing grid points, the nearer one by linear-domain distance.

Encode returns (codes uint8/uint16, mn fp32/tile, step fp32/tile); decode
inverts exactly. These are the plain versions of the ``logfmt_encode`` and
``logfmt_decode`` kernels (``repro_torch.kernels.logfmt``), step for step
in the reference's fp32 arithmetic, so the codes agree with JAX's up to
the one-level tie flips that another libm's ``log``/``exp`` can cause.
That arithmetic has no subnormals: encode flushes them in its inputs, its
grid points and the differences it compares. Decode does not flush a
value below 2^-126 as the reference does (at most 1.2e-38 apart).
Used by the compressed ring all-reduce (``repro_torch.parallel``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

TILE = 128
RANGE_CLAMP = 32.0 * math.log(2.0)   # min >= max - log(2^32)
FLT_MIN = torch.finfo(torch.float32).tiny   # 2^-126, the least normal


def _flush(t: torch.Tensor) -> torch.Tensor:
    """fp32 without subnormals, as the reference's platforms compute: a
    result below 2^-126 in magnitude is zero."""
    return torch.where(t.abs() < FLT_MIN, 0.0, t)


def _code_dtype(n_bits: int) -> torch.dtype:
    if n_bits <= 8:
        return torch.uint8
    if n_bits <= 16:
        return torch.uint16
    raise ValueError(f"LogFMT supports <=16 bits, got {n_bits}")


def encode(x: torch.Tensor, n_bits: int = 8, tile: int = TILE
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (..., d) with d % tile == 0 (pad upstream). Returns
    (codes same shape (uint), mn (..., d/tile), step (..., d/tile))."""
    assert x.shape[-1] % tile == 0, tuple(x.shape)
    code_dtype = _code_dtype(n_bits)
    levels = 2 ** (n_bits - 1) - 1          # codes 1..levels on the grid
    xf = x.float()
    t = xf.reshape(xf.shape[:-1] + (-1, tile))
    a = t.abs()
    # subnormals count as zero, as on the reference's platforms (denormals
    # are zero on XLA's CPU; the TPU flushes them), in the inputs and in the
    # grid points and differences below; NaN fails too
    nz = a >= FLT_MIN
    loga = torch.where(nz, torch.log(torch.where(nz, a, 1.0)), math.inf)
    mx = torch.where(nz, loga, -math.inf).amax(dim=-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)       # max of logs
    mn = loga.amin(dim=-1, keepdim=True)
    mn = torch.where(torch.isfinite(mn), mn, 0.0)
    mn = torch.maximum(mn, mx - RANGE_CLAMP)              # paper's E5 clamp
    # an IEEE division on every device: CUDA torch multiplies by the
    # reciprocal of a Python scalar divisor, one ulp off
    step = (mx - mn) / mx.new_tensor(float(max(levels - 1, 1)))
    step = step.clamp_min(1e-12)

    # linear-space rounding between bracketing grid points
    tt = ((loga - mn) / step).clamp(0.0, levels - 1)
    k0 = torch.floor(tt)
    k1 = (k0 + 1).clamp_max(levels - 1)
    lo = _flush(torch.exp(mn + step * k0))
    hi = _flush(torch.exp(mn + step * k1))
    k = torch.where(_flush(a - lo) > _flush(hi - a), k1, k0)
    code = torch.where(nz, (k + 1.0).to(torch.int32), 0)
    sign = ((t < 0) & nz).to(torch.int32)
    packed = (sign << (n_bits - 1)) | code
    packed = packed.reshape(xf.shape).to(code_dtype)
    return packed, mn[..., 0], step[..., 0]


def decode(codes: torch.Tensor, mn: torch.Tensor, step: torch.Tensor,
           n_bits: int = 8, tile: int = TILE,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    c = codes.to(torch.int32)
    t = c.reshape(c.shape[:-1] + (-1, tile))
    sign_mask = 1 << (n_bits - 1)
    sign = torch.where((t & sign_mask) != 0, -1.0, 1.0)
    k = (t & (sign_mask - 1)).float()
    mag = torch.exp(mn[..., None] + step[..., None] * (k - 1.0))
    val = torch.where(k == 0, 0.0, sign * mag)
    return val.reshape(codes.shape).to(dtype)


def qdq(x: torch.Tensor, n_bits: int = 8, tile: int = TILE) -> torch.Tensor:
    """Quantize-dequantize round trip (for accuracy studies)."""
    d = x.shape[-1]
    pad = (-d) % tile
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    c, mn, st = encode(xp, n_bits, tile)
    y = decode(c, mn, st, n_bits, tile, dtype=torch.float32)
    return y[..., :d].to(x.dtype)


def compressed_bits_per_element(n_bits: int, tile: int = TILE) -> float:
    """Wire cost including per-tile (mn, step) fp32 sideband."""
    return n_bits + 64.0 / tile
