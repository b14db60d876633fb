"""Compressed collectives (paper §3.2 LogFMT + §6.5 in-network compression)
— port of ``repro.parallel.collectives`` on ``torch.distributed``.

``compressed_psum`` — ring reduce-scatter + all-gather over a process
group with LogFMT-compressed hops. Intended for the *scarce* fabric (the
paper's IB between nodes): gradients cross the slow links at ~n_bits/16 of
their bf16 size. Quantization error accumulates once per reduce hop.

Each hop encodes through the ``logfmt_encode`` op, sends the codes and the
fp32 ``(mn, step)`` sideband one rank on, and decodes what it receives
through ``logfmt_decode``: on the card the hand-written kernels, on the CPU
their plain versions. Under NCCL the device tensors travel as they are;
under gloo, a payload on the card goes through pinned host buffers (the
codes and the sideband only, never the fp32 chunk).

The mesh's plain collectives (``all_reduce``, ``all_gather``,
``all_to_all``, ``exchange``) run over one process group, the group of an
axis line of ``parallel/context.Mesh``. Under gloo a CUDA payload goes
through pinned host buffers, the only way ranks that share one card can
talk (NCCL refuses two ranks on one device). Each call adds the bytes of
the buffer this rank hands it to :data:`BYTES` under its kind, and its
wall time to :data:`SECONDS` when it staged through the host.

Also the cross-replica checksums of the SDC guard (paper §6.1):
``fletcher64``/``tree_checksum`` on the tensor's device, equal to the
reference's uint32 hash bit for bit, and ``device_checksums`` of a rank's
local tensors, read back to the host.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import collections
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from repro_torch.core.logfmt import TILE
from repro_torch.kernels.logfmt import ops

_MASK = 0xFFFFFFFF


def _ring_perm(n: int, shift: int = 1):
    return [(i, (i + shift) % n) for i in range(n)]


def _neighbours(group, n: int, me: int) -> Tuple[int, int]:
    """Global ranks of the member ``me`` sends to (me + 1) and the one it
    receives from (me - 1) on the ring of ``group``."""
    g = dist.group.WORLD if group is None else group
    nxt = dict(_ring_perm(n))[me]
    prv = dict(_ring_perm(n, -1))[me]
    return dist.get_global_rank(g, nxt), dist.get_global_rank(g, prv)


# bytes this rank handed to each kind of collective, and the wall seconds
# of the calls staged through host memory (``reset_counters`` zeroes both)
BYTES: Dict[str, int] = collections.Counter()
SECONDS: Dict[str, float] = collections.Counter()


def reset_counters() -> None:
    BYTES.clear()
    SECONDS.clear()


def _staged(group, t: torch.Tensor) -> bool:
    """A CUDA payload on a gloo group crosses through pinned host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Pinned host copies of CUDA tensors, after one wait for the copies."""
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in ts]
    for h, t in zip(host, ts):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(ts[0].device).synchronize()
    return host


def _count(kind: str, nbytes: int, t0: Optional[float]) -> None:
    BYTES[kind] += nbytes
    if t0 is not None:
        SECONDS[kind] += time.perf_counter() - t0


def _exchange(payload: Sequence[torch.Tensor], group, nxt: int, prv: int
              ) -> List[torch.Tensor]:
    """Send each tensor of ``payload`` to global rank ``nxt`` and receive
    one of the same shape and type from ``prv``, all in one
    ``batch_isend_irecv``. Under gloo a payload on the card is staged
    through pinned host buffers and the received tensors go back to it."""
    dev = payload[0].device
    staged = dev.type == "cuda" and dist.get_backend(group) == "gloo"
    t0 = time.perf_counter() if staged else None
    send = _to_host(payload) if staged else list(payload)
    recv = [torch.empty(t.shape, dtype=t.dtype, device=t.device,
                        pin_memory=staged) for t in send]
    p2p = ([dist.P2POp(dist.isend, t, nxt, group, tag)
            for tag, t in enumerate(send)]
           + [dist.P2POp(dist.irecv, t, prv, group, tag)
              for tag, t in enumerate(recv)])
    for work in dist.batch_isend_irecv(p2p):
        work.wait()
    if staged:
        recv = [t.to(dev, non_blocking=True) for t in recv]
    _count("exchange", sum(t.numel() * t.element_size() for t in send), t0)
    return recv


def exchange(payload: Sequence[torch.Tensor], group, nxt: int, prv: int
             ) -> List[torch.Tensor]:
    """Point-to-point exchange inside ``group``: send to the group member
    ``nxt`` and receive from ``prv`` (ranks within the group)."""
    return _exchange(payload, group, dist.get_global_rank(group, nxt),
                     dist.get_global_rank(group, prv))


def _bytes_view(x: torch.Tensor) -> torch.Tensor:
    """x's bytes as a uint8 tensor ``(x.shape[0], -1)``."""
    return x.contiguous().reshape(-1).view(torch.uint8).reshape(
        x.shape[0], -1)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum (``op="sum"``) or max (``"max"``) of ``x`` over ``group``, in a
    new tensor: every member gets the same bytes."""
    t0 = time.perf_counter() if _staged(group, x) else None
    buf = _to_host([x])[0] if t0 is not None else x.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    if t0 is not None:
        buf = buf.to(x.device, non_blocking=True)
    _count("all_reduce", x.numel() * x.element_size(), t0)
    return buf


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim`` in group-rank order
    (moved as bytes: any dtype)."""
    n = dist.get_world_size(group)
    t0 = time.perf_counter() if _staged(group, x) else None
    src = x.movedim(dim, 0).contiguous()
    b = _bytes_view(src)
    if t0 is not None:
        b = _to_host([b])[0]
    parts = [torch.empty_like(b) for _ in range(n)]
    dist.all_gather(parts, b, group=group)
    out = torch.cat(parts).view(src.dtype).reshape(
        (n * src.shape[0],) + src.shape[1:])
    if t0 is not None:
        out = out.to(x.device, non_blocking=True)
    _count("all_gather", x.numel() * x.element_size(), t0)
    return out.movedim(0, dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-to-all over ``group`` along axis 0: ``x`` is ``(n * c,
    ...)``; chunk j goes to member j, and the result's chunk j came from
    member j (JAX's ``all_to_all(x, axis, 0, 0, tiled=True)``). Moved as
    bytes, so any dtype crosses as it is."""
    t0 = time.perf_counter() if _staged(group, x) else None
    b = _bytes_view(x)
    if t0 is not None:
        b = _to_host([b])[0]
    out = torch.empty_like(b)
    dist.all_to_all_single(out, b, group=group)
    out = out.view(x.dtype).reshape(x.shape)
    if t0 is not None:
        out = out.to(x.device, non_blocking=True)
    _count("all_to_all", x.numel() * x.element_size(), t0)
    return out


def compressed_psum(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
                    n_bits: int = 8) -> torch.Tensor:
    """Sum ``x`` across ``group`` with LogFMT-compressed ring hops.

    Every member of ``group`` (the default group if None) calls it with
    an ``x`` of the same shape: any (..., d), with d padded to the LogFMT
    tile internally. Returns the summed tensor (the same on every member,
    like an all-reduce), in ``x``'s dtype.
    """
    n = dist.get_world_size(group)
    if n == 1:
        return x
    me = dist.get_rank(group)
    nxt, prv = _neighbours(group, n, me)
    shape = x.shape
    d = shape[-1]
    pad = (-d) % TILE
    xf = x.float().reshape(-1, d)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    rows = xf.shape[0]
    # split rows into n chunks (pad rows)
    rpad = (-rows) % n
    if rpad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, rpad))
    chunks = xf.reshape(n, -1, xf.shape[-1])

    def send(c):
        """One compressed ring hop i -> i+1."""
        codes, mn, step = ops.logfmt_encode(c, n_bits=n_bits)
        wire, mn, step = _exchange([codes.view(torch.uint8), mn, step],
                                   group, nxt, prv)
        return ops.logfmt_decode(wire.view(codes.dtype), mn, step,
                                 n_bits=n_bits, dtype=torch.float32)

    # --- reduce-scatter: at hop t member i forwards its running chunk and
    # accumulates chunk (i - t - 1); after n-1 hops it owns chunk (i+1) ----
    acc = chunks[me]
    for t in range(n - 1):
        acc = send(acc) + chunks[(me - t - 1) % n]
    # --- all-gather: rotate the reduced chunks around (compressed) -------
    out = torch.empty_like(chunks)
    out[(me + 1) % n] = acc
    cur = acc
    for t in range(1, n):
        cur = send(cur)
        out[(me + 1 - t) % n] = cur
    y = out.reshape(-1, xf.shape[-1])[:rows, :d]
    return y.reshape(shape).to(x.dtype)


def _np_fletcher64(a) -> int:
    """Host-side mirror of ``fletcher64`` for per-shard checksumming."""
    b = np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)
    b = b.ravel().astype(np.uint64)
    i = np.arange(1, b.size + 1, dtype=np.uint64)
    s1 = int(b.sum()) & 0xFFFFFFFF
    s2 = int((b * i).sum()) & 0xFFFFFFFF
    return s1 ^ ((s2 << 1) & 0xFFFFFFFF)


def device_checksums(tree, group: Optional[dist.ProcessGroup] = None
                     ) -> Dict[int, int]:
    """Checksum of this rank's local tensors, as ``{rank: checksum}``.

    Real per-replica measurement (paper §6.1): each floating-point
    tensor's resident bytes are read back and fletcher-summed on the host,
    XOR-combined across tensors. ``rank`` is this process's rank in
    ``group`` (0 without a process group), as the reference keys each
    shard by its device. The SDC guard compares two independent
    read-backs.
    """
    rank = dist.get_rank(group) if dist.is_initialized() else 0
    out: Dict[int, int] = {}
    for leaf in tree_leaves(tree):
        if not (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()):
            continue
        c = _np_fletcher64(leaf.detach().float().cpu().numpy())
        out[rank] = out.get(rank, 0) ^ c
    return out


def _sum_mod32(v: torch.Tensor) -> torch.Tensor:
    """Σ v mod 2^32 for int64 values in [0, 2^32), summed in 16-bit halves
    so that no partial sum leaves int64 (2^47 values at most)."""
    lo = (v & 0xFFFF).sum()
    hi = (v >> 16).sum()
    return (lo + ((hi & 0xFFFF) << 16)) & _MASK


def fletcher64(x: torch.Tensor) -> torch.Tensor:
    """Cheap on-device checksum of a tensor (SDC guard, paper §6.1).
    DP replicas must agree bit-for-bit; divergence flags silent corruption.

    The reference's uint32 arithmetic with wrap-around, emulated exactly
    in int64 (a 0-d int64 tensor holding the uint32 value): the words and
    their 1-based indices mod 2^32, each product b*i mod 2^32 from the
    16-bit halves of b (each half times i stays below 2^48)."""
    b = x.reshape(-1).float().contiguous().view(torch.int32).to(torch.int64)
    b = b & _MASK
    i = torch.arange(1, b.numel() + 1, dtype=torch.int64,
                     device=b.device) & _MASK
    prod = ((b & 0xFFFF) * i + ((((b >> 16) * i) & 0xFFFF) << 16)) & _MASK
    s1 = _sum_mod32(b)
    s2 = _sum_mod32(prod)
    return s1 ^ ((s2 << 1) & _MASK)


def tree_checksum(tree) -> torch.Tensor:
    leaves = [fletcher64(l) for l in tree_leaves(tree)
              if isinstance(l, torch.Tensor) and l.is_floating_point()]
    out = torch.zeros((), dtype=torch.int64,
                      device=leaves[0].device if leaves else None)
    for l in leaves:
        out = out ^ l.to(out.device)
    return out
