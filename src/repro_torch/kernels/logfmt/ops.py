"""LogFMT-nBit codec: the ``logfmt_encode`` and ``logfmt_decode`` ops, their
plain versions and their CUDA launchers.

Replace the TPU kernels ``src/repro/kernels/logfmt/logfmt.py``
(``logfmt_encode``, :72, ``pallas_call`` at :79; ``logfmt_decode``, :99,
``pallas_call`` at :107), behind the same entry points as
``repro/kernels/logfmt/ops.py``:

    logfmt_encode(x, n_bits=8)  -> codes, mn, step
        x (..., D) fp32/bf16, D % 128 == 0; codes (..., D) uint8 (n_bits
        <= 8) or uint16 (9-16 bits); mn, step (..., D/128) fp32
    logfmt_decode(codes, mn, step, n_bits=8, dtype=torch.bfloat16)
        -> (..., D) in ``dtype`` (fp32 or bf16 on the card)

Both reshape any ``(..., D)`` to 2-D and back. The plain versions are
``repro_torch.core.logfmt``'s ``encode``/``decode``, the codec the JAX
kernels are held against (``repro/kernels/logfmt/ref.py``). The decode
kernel (``csrc/logfmt_decode.cu``) runs one warp per 1x128 tile; the encode
kernel (``csrc/logfmt_encode.cu``) one warp per four consecutive tiles at a
time, over as many blocks as fit on the card. Neither pads: the JAX op's
padding to its ``(bn, bd)`` block grid is TPU blocking and has no
counterpart here.

What bounds them on an H100: the bytes. Encode reads x once and writes the
codes and the sideband once; decode the reverse. Decode spends one ``expf``
a value. Encode spends its exact transcendentals per tile, not per value
(``csrc/logfmt_encode.cu``): the tile's range from two ``logf`` of the
integer min and max of |x|, each value's level from an ``lg2.approx``
estimate wherever an error bound settles it, the reference's comparison of
two grid points where it does not, and the reference's arithmetic for a
whole tile whose step is under 2^-13. At the compressed ring's hop chunk it
takes 71% of the byte bound at 8 bits and 77% at 10 (the first version,
one ``logf``, a division and two ``expf`` a value: 38% and 46%); what each
lever gave: ``PERF.md`` §6, from ``kernels/logfmt/probe.py``.

Encode treats a subnormal input (|x| < 2^-126) as zero, and a grid point or
difference below 2^-126 as zero, as the plain version and the reference's
platforms do.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core import logfmt
from repro_torch.core.logfmt import TILE
from repro_torch.kernels import build, registry

# the value types the kernels read (encode) and write (decode)
_VALUE_CODE = {torch.float32: 0, torch.bfloat16: 1}

logfmt_encode = registry.op(
    "logfmt_encode",
    replaces="src/repro/kernels/logfmt/logfmt.py:72 logfmt_encode")
logfmt_decode = registry.op(
    "logfmt_decode",
    replaces="src/repro/kernels/logfmt/logfmt.py:99 logfmt_decode")


def _as2d(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 0 or x.shape[-1] % TILE:
        raise ValueError(f"LogFMT feature dim must be a multiple of {TILE}, "
                         f"got {tuple(x.shape)}")
    return x.reshape(-1, x.shape[-1])


def _sideband_shape(shape) -> Tuple[int, ...]:
    return tuple(shape[:-1]) + (shape[-1] // TILE,)


@logfmt_encode.plain
def logfmt_encode_plain(x: torch.Tensor, *, n_bits: int = 8):
    shape = x.shape
    codes, mn, step = logfmt.encode(_as2d(x), n_bits)
    side = _sideband_shape(shape)
    return codes.reshape(shape), mn.reshape(side), step.reshape(side)


@logfmt_decode.plain
def logfmt_decode_plain(codes: torch.Tensor, mn: torch.Tensor,
                        step: torch.Tensor, *, n_bits: int = 8,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    shape = codes.shape
    c2 = _as2d(codes)
    side = (c2.shape[0], c2.shape[1] // TILE)
    y = logfmt.decode(c2, mn.reshape(side), step.reshape(side), n_bits,
                      dtype=dtype)
    return y.reshape(shape)


def _check_bits(n_bits: int) -> None:
    if not 2 <= n_bits <= 16:
        raise ValueError(f"LogFMT kernels take 2-16 bits, got {n_bits}")


# the positive normal floats, as bit patterns
NORMALS = (0x00800000, 0x7f7fffff)


def logf_sweep(device: torch.device, first: int = NORMALS[0],
               last: int = NORMALS[1]) -> int:
    """How many bit patterns b in [first, last) the encode kernel's ``logf``
    takes to a smaller value at float(b + 1) than at float(b). The kernel
    takes a tile's min and max of the logs from the logs of its min and max
    |x|, which is the reference's wherever this is 0."""
    count = torch.zeros(1, dtype=torch.int64, device=device)
    fn = build.entry("logfmt_encode", "logfmt_logf_sweep",
                     [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                      ctypes.c_void_p])
    err = fn(first, last, registry.ptr(count), registry.stream_ptr(count))
    if err:
        raise RuntimeError(f"logfmt_logf_sweep: CUDA error {err}")
    return int(count.item())


@functools.cache
def _entry(name: str):
    v = ctypes.c_void_p
    i = ctypes.c_int
    return build.entry(name, name, [v, v, v, v, ctypes.c_longlong, i, i, v])


@logfmt_encode.cuda
def _logfmt_encode_cuda(x: torch.Tensor, *, n_bits: int = 8):
    _check_bits(n_bits)
    code = _VALUE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"logfmt_encode: the CUDA kernel takes fp32 or bf16, "
                        f"got {x.dtype}")
    shape = x.shape
    x2 = registry.contiguous16(_as2d(x))
    N, D = x2.shape
    codes = torch.empty((N, D), dtype=logfmt._code_dtype(n_bits),
                        device=x.device)
    mn = torch.empty((N, D // TILE), dtype=torch.float32, device=x.device)
    step = torch.empty_like(mn)
    tiles = N * D // TILE
    if tiles:
        P = registry.ptr
        logfmt_encode.launch(_entry("logfmt_encode"), P(x2), P(codes), P(mn),
                             P(step), tiles, n_bits, code,
                             registry.stream_ptr(codes))
    side = _sideband_shape(shape)
    return codes.reshape(shape), mn.reshape(side), step.reshape(side)


@logfmt_decode.cuda
def _logfmt_decode_cuda(codes: torch.Tensor, mn: torch.Tensor,
                        step: torch.Tensor, *, n_bits: int = 8,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    _check_bits(n_bits)
    code = _VALUE_CODE.get(dtype)
    if code is None:
        raise TypeError(f"logfmt_decode: the CUDA kernel writes fp32 or bf16, "
                        f"got {dtype}")
    if codes.dtype != logfmt._code_dtype(n_bits):
        raise TypeError(f"logfmt_decode: {n_bits}-bit codes are "
                        f"{logfmt._code_dtype(n_bits)}, got {codes.dtype}")
    shape = codes.shape
    c2 = registry.contiguous16(_as2d(codes))
    N, D = c2.shape
    side = (N, D // TILE)
    if (mn.dtype != torch.float32 or step.dtype != torch.float32
            or mn.numel() != N * side[1] or step.numel() != N * side[1]):
        raise ValueError(f"logfmt_decode: mn and step must be fp32 with "
                         f"{N * side[1]} values (one per tile of "
                         f"{tuple(shape)}), got {mn.dtype} "
                         f"{tuple(mn.shape)} / {step.dtype} "
                         f"{tuple(step.shape)}")
    if not (c2.is_cuda and mn.is_cuda and step.is_cuda):
        raise TypeError("logfmt_decode: every operand must be on the card")
    mn2, step2 = mn.contiguous(), step.contiguous()
    out = torch.empty((N, D), dtype=dtype, device=codes.device)
    tiles = N * D // TILE
    if tiles:
        P = registry.ptr
        logfmt_decode.launch(_entry("logfmt_decode"), P(c2), P(mn2),
                             P(step2), P(out), tiles, n_bits, code,
                             registry.stream_ptr(out))
    return out.reshape(shape)
