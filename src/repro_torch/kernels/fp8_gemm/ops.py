"""Fine-grained-scaled FP8 GEMM: op, plain version, launch plan and CUDA
launcher.

Replaces the TPU kernel ``src/repro/kernels/fp8_gemm/fp8_gemm.py``
(``fp8_gemm``, :49; ``pallas_call`` at :59):

    y = (xq · xs) @ (wq · ws)      xq (M,K) E4M3, xs (M,K/128) fp32 (1x128
                                   tiles); wq (K,N) E4M3, ws (K/128,
                                   ceil(N/128)) fp32 (128x128 blocks);
                                   y (M,N) fp32

The kernels (``csrc/fp8_gemm.cu``) convert the E4M3 codes exactly to fp16
and multiply each 128-deep K group on the tensor cores into a fresh fp32
partial, then add ``partial · xs[m,k] · ws[k,n]`` into the fp32
accumulator: the paper's §3.1 promotion of each 128-K partial into full
precision.

The weight is read K-contiguous: ``wq`` is the ``(K, N)`` transpose view
of an ``(N, K)`` row-major buffer (``core.fp8.k_major``), laid out once at
load by ``bridge.prepare_for_serving``. Four codes adjacent in K then fill
one 32-bit word, and a TMA box of (128 rows of N) x (128 bytes of K) is a
plain 2-D tile. The CUDA route raises on any other layout: it never
copies a weight per call.

What bounds it on an H100, and the two regimes of the launch plan
(:func:`launch_plan`, from M, N, K and the SM count alone, so a CUDA graph
can capture a call and nothing is read on the host):

* decode, ``M <= DECODE_MAX_M``: the weight bytes over 3.35 TB/s. The
  (128-row N tile, 128-deep K group) units of the weight are split evenly
  over the CTAs resident on the card (stream-K); each CTA streams its units
  through a TMA ring and writes one fp32 partial per tile it touches to a
  workspace, and a second kernel sums each tile's partials in a fixed
  order (the same bits every run). One op call counts one launch.
* prefill, larger M: the tensor cores. Persistent CTAs walk 128 x 128
  output tiles; ``wgmma`` takes x from registers and the weight, converted
  to fp16, from shared memory, fed by a TMA ring. Where the tiles would
  fill under half the SMs, each tile's K is split as well, and the same
  reduce kernel sums the splits in order.

``fp8_matmul(x, w)`` is the caller-facing function: it quantizes x per
1x128 tile (plain tensor code, as in the reference) and takes w either as
a tensor, quantized per call like the reference (and laid out K-contiguous
for the kernel), or as a ``core.fp8.Fp8Weight`` quantized once at load.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple, Union

import torch

from repro_torch.core import fp8
from repro_torch.kernels import build, registry

BLOCK = 128          # scale granularity (fixed by the format)
DECODE_MAX_M = 64    # up to 8 n8 tiles of x rows: the decode kernel
PREFILL_TILE = 128   # output tile of the prefill kernel (rows and columns)
PREFILL_GROUP_M = 8  # M tiles per group of the prefill kernel's tile order

# every (K, N) the served DeepSeek-V3 paths give fp8_gemm, by weight
# (core/mla.py, models/layers.py, core/mtp.py)
SERVED_KN = {"w_dq": (7168, 1536), "w_uq": (1536, 24576),
             "w_dkv": (7168, 512), "w_kr": (7168, 64),
             "w_uk/w_uv": (512, 16384), "w_o": (16384, 7168),
             "w_gate/w_up": (7168, 18432), "w_down": (18432, 7168),
             "w_proj": (14336, 7168)}

fp8_gemm = registry.op(
    "fp8_gemm", replaces="src/repro/kernels/fp8_gemm/fp8_gemm.py:49 fp8_gemm")


def ctas_per_sm(M: int) -> int:
    """Decode CTAs resident on an SM: two up to 24 x rows, one above (the
    kernel's ``Dec<NT8>::CTAS``)."""
    return 2 if M <= 24 else 1


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call is launched. ``mode`` "decode": ``grid`` CTAs, CTA c
    taking units ``[c·per, (c+1)·per)`` of the N-tile-major list of
    (N tile, K group) units, at most ``maxc`` CTAs a tile; "prefill":
    ``grid`` persistent CTAs over the 128 x 128 output tiles, each tile's
    K groups split into ``maxc`` contiguous ranges (``per`` is 0)."""
    mode: str
    grid: int
    per: int = 0
    maxc: int = 0

    def workspace_floats(self, M: int, N: int) -> int:
        """fp32 partials: one (M, 128) slab per N tile and CTA of the tile
        (decode) or K split (prefill); none for an unsplit prefill."""
        if self.mode == "prefill" and self.maxc == 1:
            return 0
        return -(-N // BLOCK) * self.maxc * M * BLOCK


@functools.lru_cache(maxsize=4096)
def launch_plan(M: int, N: int, K: int, sms: int) -> Plan:
    """The launch plan of an (M, K) x (K, N) call on a card with ``sms``
    SMs. K is a multiple of 128."""
    NB, KB = -(-N // BLOCK), K // BLOCK
    if M <= DECODE_MAX_M:
        units = NB * KB
        per = -(-units // min(units, ctas_per_sm(M) * sms))
        grid = -(-units // per)
        maxc = max((((nt + 1) * KB - 1) // per) - (nt * KB // per) + 1
                   for nt in range(NB))
        return Plan("decode", grid, per, maxc)
    tiles = -(-M // PREFILL_TILE) * NB
    splits = min(KB, sms // tiles) if 2 * tiles <= sms else 1
    return Plan("prefill", min(tiles * splits, sms), 0, splits)


def prefill_tile(i: int, MB: int, NB: int) -> Tuple[int, int]:
    """(M tile, N tile) of tile i in the prefill kernel's order: groups of
    ``PREFILL_GROUP_M`` M tiles, M fastest within a group (the kernel's
    ``pf_tile``)."""
    per_group = PREFILL_GROUP_M * NB
    first = (i // per_group) * PREFILL_GROUP_M
    rows = min(MB - first, PREFILL_GROUP_M)
    r = i % per_group
    return first + r % rows, r // rows


def plan_work(plan: Plan, M: int, N: int, K: int
              ) -> List[List[Tuple[int, int, int]]]:
    """Per CTA, the (M tile, N tile, K group) units it computes, by the
    kernels' own index arithmetic (decode: the M tile is 0, all M rows)."""
    NB, KB = -(-N // BLOCK), K // BLOCK
    if plan.mode == "decode":
        units = NB * KB
        return [[(0, u // KB, u % KB)
                 for u in range(c * plan.per, min((c + 1) * plan.per, units))]
                for c in range(plan.grid)]
    MB, S = -(-M // PREFILL_TILE), plan.maxc
    out = []
    for c in range(plan.grid):
        work = []
        for i in range(c, MB * NB * S, plan.grid):
            mt, nt = prefill_tile(i // S, MB, NB)
            j = i % S
            work += [(mt, nt, kb) for kb in range(j * KB // S,
                                                  (j + 1) * KB // S)]
        out.append(work)
    return out


@fp8_gemm.plain
def fp8_gemm_plain(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                   ws: torch.Tensor) -> torch.Tensor:
    """Dequantize, then an fp32 GEMM (``kernels/fp8_gemm/ref.py``): the
    same value as per-group scaled accumulation. K is a multiple of 128;
    N may be ragged (padded here to the scale blocks). ``wq`` may have any
    strides (the kernel's K-contiguous layout included): the dequantized
    weight is made row-major, so the result does not depend on them."""
    M, K = xq.shape
    N = wq.shape[1]
    kb, nb = K // BLOCK, -(-N // BLOCK)
    x = (xq.float().reshape(M, kb, BLOCK) * xs[..., None]).reshape(M, K)
    w = torch.nn.functional.pad(wq.float(), (0, nb * BLOCK - N))
    w = (w.reshape(kb, BLOCK, nb, BLOCK) * ws[:, None, :, None])
    return torch.matmul(x, w.reshape(K, nb * BLOCK)[:, :N].contiguous())


@functools.cache
def _entry():
    v, i = ctypes.c_void_p, ctypes.c_int
    return build.entry("fp8_gemm", "fp8_gemm",
                       [v, v, v, v, v, v, i, i, i, ctypes.c_long, i, i, i, i,
                        v])


def k_contiguous(wq: torch.Tensor) -> bool:
    """Whether a (K, N) weight is the transpose view of an (N, K)
    row-major buffer (the kernel's layout; a single column counts)."""
    K, N = wq.shape
    return wq.stride(0) == 1 and (N == 1 or wq.stride(1) >= K)


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
    if K % BLOCK or wq.shape[0] != K:
        raise ValueError(f"fp8_gemm: K ({K}) must be a multiple of {BLOCK} "
                         f"and agree, got {tuple(xq.shape)} x "
                         f"{tuple(wq.shape)}")
    if xs.shape != (M, K // BLOCK) or ws.shape != (K // BLOCK,
                                                   -(-N // BLOCK)):
        raise ValueError(f"fp8_gemm: scale shapes {tuple(xs.shape)}, "
                         f"{tuple(ws.shape)} do not match {M}x{K}x{N}")
    if not k_contiguous(wq):
        raise ValueError(f"fp8_gemm: the weight must be K-contiguous (the "
                         f"(K, N) view of an (N, K) row-major buffer, "
                         f"core.fp8.k_major), got strides {wq.stride()}")
    ldw = max(wq.stride(1), K)
    if wq.data_ptr() % 16 or ldw % 16:
        raise ValueError("fp8_gemm: the weight's base and rows must be "
                         "16-byte aligned")
    y = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    if M == 0 or N == 0:
        return y
    xq = registry.contiguous16(xq)
    xs, ws = xs.contiguous(), ws.contiguous()
    plan = launch_plan(M, N, K, registry.sm_count(xq.device))
    part: Optional[torch.Tensor] = None
    if plan.workspace_floats(M, N):
        part = torch.empty(plan.workspace_floats(M, N), dtype=torch.float32,
                           device=xq.device)
    P = registry.ptr
    fp8_gemm.launch(_entry(), P(xq), P(xs), P(wq), P(ws), P(y), P(part), M,
                    N, K, ldw, 0 if plan.mode == "decode" else 1, plan.grid,
                    plan.per, plan.maxc, registry.stream_ptr(y))
    return y


def operands(x: torch.Tensor, w: Union[torch.Tensor, fp8.Fp8Weight],
             x_amax: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """``(xq, xs, wq, ws)`` of ``fp8_matmul(x, w)``: x quantized per 1x128
    tile, w per 128x128 block (or as held by its Fp8Weight) and laid out
    K-contiguous, K zero-padded to the 128 grid.

    The training backward passes operands the forward never does: a
    transposed, non-contiguous x (``x2ᵀ`` of the weight gradient), a plain
    tensor as the "weight" (the gradient ``g2``, or ``wᵀ``), a token
    count K that is no multiple of 128, and K = 64 (``w_kr``'s input
    gradient). Each is quantized and laid out here as the forward lays
    out an unprepared weight."""
    if isinstance(w, fp8.Fp8Weight):
        wq, ws = w.wq, w.ws
    else:
        wq, ws = fp8.quantize_blockwise(w)
        wq = fp8.k_major(wq)
    xq, xs = fp8.quantize_tilewise(x, amax=x_amax)
    if xq.shape[1] % BLOCK:
        # K to the 128 grid: padding quantizes to zeros, so it changes
        # neither the tile/block scales nor the product (every served K is
        # a multiple of 128 already)
        xq = _pad_fp8(xq, 1, BLOCK)
        wq = _pad_fp8(wq.t(), 1, BLOCK).t()      # stays K-contiguous
    return xq, xs, wq, ws


def fp8_matmul(x: torch.Tensor,
               w: Union[torch.Tensor, fp8.Fp8Weight],
               x_amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = Q(x) @ Q(w) in fp32. x: (M, K); w: (K, N) or its Fp8Weight;
    ``x_amax`` (M, ceil(K/128)): x's tile amaxes, where a tensor-parallel
    rank holds part of each tile."""
    return fp8_gemm(*operands(x, w, x_amax))


def _pad_fp8(q: torch.Tensor, dim: int, mult: int) -> torch.Tensor:
    """Zero-pad an E4M3 tensor (through its bytes: the byte 0 is +0.0)."""
    return registry.pad_to_multiple(q.view(torch.uint8), dim,
                                    mult).view(fp8.E4M3)
