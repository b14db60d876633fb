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
the buffer this rank hands it to :data:`BYTES` under its kind, and the
host's seconds inside it to :data:`SECONDS` when it staged through the
host.

Each has an issued form (``all_to_all_start`` and so on) that returns a
:class:`Pending` whose ``wait()`` gives the result, so that a caller can
queue other work while the collective is in flight (the dual-microbatch
decode, ``parallel/overlap.py``); the plain call is the issue, waited at
once. Under gloo the issue stages the payload (the host waits for its
copy alone) and hands it to the group's threads; the wait takes the
result back to the card. Under NCCL (written, not yet run: it needs a
card a rank) the issue is ``async_op=True`` on the card's tensors and
the wait makes the current stream wait. :func:`record` lists every
collective issued in a block with its kind, bytes, group, the layer and
half that issued it (:func:`tagged`) and its pass (``phase``, ``"fwd"``
or ``"bwd"``), beside the caller's marks.

Training differentiates through them (explicit SPMD has no GSPMD to
transpose its collectives): :func:`reduce_sum` (sum; backward the
identity), :func:`copy_to_group` (the identity; backward the sum: the
pair of Megatron's ``g`` and ``f``), :func:`gather` (backward this
rank's slice where the consumer is replicated, else the reduce-scatter),
:func:`scatter_sum` (the reduce-scatter; backward the gather),
:func:`split` (this member's part of a replicated tensor; backward the
gather) and
:func:`waited` (any issued collective, with its transpose as its
backward: the reverse all-to-all, the reverse exchange). Without grad
they are the plain calls. A backward's collectives run in autograd's
order, tagged with the layer and half of their forward and
``phase="bwd"``. :func:`sharded_global_norm` is the gradient norm over
a mesh.

Also the cross-replica checksums of the SDC guard (paper §6.1):
``fletcher64``/``tree_checksum`` on the tensor's device, equal to the
reference's uint32 hash bit for bit, and ``device_checksums`` of a rank's
local tensors, read back to the host.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import collections
import contextlib
import dataclasses
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
# the host spent inside the calls staged through host memory, issue and
# wait (``reset_counters`` zeroes both)
BYTES: Dict[str, int] = collections.Counter()
SECONDS: Dict[str, float] = collections.Counter()


def reset_counters() -> None:
    BYTES.clear()
    SECONDS.clear()


# ---------------------------------------------------------------------------
# the record of collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Entry:
    """One collective of a :class:`Record` (or one mark, ``event ==
    "mark"``, zero bytes): its kind, the bytes this rank handed it, its
    process group, the layer and half that issued it (the tags of
    :func:`tagged` at the issue; None outside them), and the host's
    ``perf_counter`` at the start and end of its issue and of its wait
    (``issued``, ``waited``; a mark has neither wait nor end), and the
    pass that issued it (``phase``)."""
    kind: str
    nbytes: int
    group: Any
    layer: Optional[str]
    half: Optional[str]
    event: str                      # "collective" | "mark"
    issued: Tuple[float, float] = (0.0, 0.0)
    waited: Optional[Tuple[float, float]] = None
    phase: str = "fwd"              # "fwd" | "bwd" (a backward's)


class Record:
    """The collectives a block issued, in order (:func:`record`).
    ``events`` lists ``("issue" | "wait" | "mark", entry)`` in program
    order; ``entries`` the entries in order of issue."""

    def __init__(self):
        self.events: List[Tuple[str, Entry]] = []

    @property
    def entries(self) -> List[Entry]:
        return [e for ev, e in self.events if ev in ("issue", "mark")]

    def collectives(self, kind: Optional[str] = None) -> List[Entry]:
        return [e for e in self.entries if e.event == "collective"
                and (kind is None or e.kind == kind)]

    def in_flight_s(self, kind: Optional[str] = None) -> float:
        """Seconds between the end of each collective's issue and the start
        of its wait, summed: the host time it was in flight while the
        caller queued other work."""
        return sum(e.waited[0] - e.issued[1] for e in self.collectives(kind)
                   if e.waited is not None)

    def position(self, event: str, **match) -> int:
        """Index in ``events`` of the first event of kind ``event`` whose
        entry's fields equal ``match``."""
        for i, (ev, e) in enumerate(self.events):
            if ev == event and all(getattr(e, k) == v
                                   for k, v in match.items()):
                return i
        raise KeyError((event, match))


_RECORD: Optional[Record] = None
_TAG: Dict[str, Optional[str]] = {"layer": None, "half": None,
                                  "phase": None}


@contextlib.contextmanager
def record():
    """Record every collective issued in the block, and every
    :func:`mark` (the port's own count of its collectives, read by tests
    and ``chip_smoke.py``). Yields the :class:`Record`."""
    global _RECORD
    prev, _RECORD = _RECORD, Record()
    try:
        yield _RECORD
    finally:
        _RECORD = prev


@contextlib.contextmanager
def tagged(layer: Optional[str] = None, half: Optional[str] = None,
           phase: Optional[str] = None):
    """Tag the collectives and marks issued in the block with the layer and
    the half (``"A"``/``"B"`` of a dual microbatch) that issue them, and
    the pass (``phase="bwd"`` inside a backward; None: the forward)."""
    prev = dict(_TAG)
    _TAG.update(layer=layer, half=half, phase=phase)
    try:
        yield
    finally:
        _TAG.update(prev)


def mark(kind: str) -> None:
    """Note, in the open record, that the caller starts ``kind`` (say,
    ``"attention"``) now, under the current tags."""
    if _RECORD is not None:
        t = time.perf_counter()
        _RECORD.events.append(("mark", Entry(kind, 0, None, _TAG["layer"],
                                             _TAG["half"], "mark", (t, t),
                                             phase=_TAG["phase"] or "fwd")))


# ---------------------------------------------------------------------------
# issue and wait
# ---------------------------------------------------------------------------


class Pending:
    """A collective in flight. ``wait()`` waits for it and returns its
    result (the same object on a later call). Under gloo the transfer runs
    on the process group's threads from the issue on; on a card under
    NCCL, ``wait()`` makes the current stream wait for the collective's
    stream (the host does not block)."""

    def __init__(self, kind: str, works, finish, staged: bool,
                 entry: Optional[Entry] = None, rec: Optional[Record] = None):
        self._kind, self._works, self._finish = kind, list(works), finish
        # the record the issue went to takes the wait too
        self._staged, self._entry, self._rec = staged, entry, rec
        self._done, self._out = False, None

    def wait(self):
        if self._done:
            return self._out
        t0 = time.perf_counter()
        for w in self._works:
            w.wait()
        self._out = self._finish()
        t1 = time.perf_counter()
        if self._staged:
            SECONDS[self._kind] += t1 - t0
        if self._entry is not None:
            self._entry.waited = (t0, t1)
            self._rec.events.append(("wait", self._entry))
        self._done, self._works, self._finish = True, [], None
        self._rec = None
        return self._out


def _issue(kind: str, nbytes: int, group, staged: bool, t0: float, works,
           finish) -> Pending:
    """Count an issued collective (bytes, staged seconds, the record) and
    wrap it."""
    t1 = time.perf_counter()
    BYTES[kind] += nbytes
    if staged:
        SECONDS[kind] += t1 - t0
    entry = None
    if _RECORD is not None:
        entry = Entry(kind, nbytes, group, _TAG["layer"], _TAG["half"],
                      "collective", (t0, t1), phase=_TAG["phase"] or "fwd")
        _RECORD.events.append(("issue", entry))
    return Pending(kind, works, finish, staged, entry, _RECORD)


def _staged(group, t: torch.Tensor) -> bool:
    """A CUDA payload on a gloo group crosses through pinned host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Pinned host copies of CUDA tensors. The host waits for the copies
    alone (an event recorded right after them, behind the payload's
    producers), not for whatever the stream is given later."""
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in ts]
    for h, t in zip(host, ts):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(ts[0].device))
    done.synchronize()
    return host


def _back(t: torch.Tensor, device, staged: bool) -> torch.Tensor:
    """A received host buffer back to the payload's card (queued on the
    current stream; the caching host allocator keeps the pinned block
    until the copy has run)."""
    return t.to(device, non_blocking=True) if staged else t


def _exchange_start(payload: Sequence[torch.Tensor], group, nxt: int,
                    prv: int) -> Pending:
    """Issue: send each tensor of ``payload`` to global rank ``nxt`` and
    receive one of the same shape and type from ``prv``, all in one
    ``batch_isend_irecv``. Under gloo a payload on the card is staged
    through pinned host buffers and the received tensors go back to it."""
    dev = payload[0].device
    staged = dev.type == "cuda" and dist.get_backend(group) == "gloo"
    t0 = time.perf_counter()
    send = _to_host(payload) if staged else list(payload)
    recv = [torch.empty(t.shape, dtype=t.dtype, device=t.device,
                        pin_memory=staged) for t in send]
    p2p = ([dist.P2POp(dist.isend, t, nxt, group, tag)
            for tag, t in enumerate(send)]
           + [dist.P2POp(dist.irecv, t, prv, group, tag)
              for tag, t in enumerate(recv)])
    works = dist.batch_isend_irecv(p2p)
    return _issue("exchange", sum(t.numel() * t.element_size() for t in send),
                  group, staged, t0, works,
                  lambda: [_back(t, dev, staged) for t in recv])


def _exchange(payload: Sequence[torch.Tensor], group, nxt: int, prv: int
              ) -> List[torch.Tensor]:
    return _exchange_start(payload, group, nxt, prv).wait()


def exchange_start(payload: Sequence[torch.Tensor], group, nxt: int,
                   prv: int) -> Pending:
    """Issue a point-to-point exchange inside ``group``: send to the group
    member ``nxt`` and receive from ``prv`` (ranks within the group)."""
    return _exchange_start(payload, group, dist.get_global_rank(group, nxt),
                           dist.get_global_rank(group, prv))


def exchange(payload: Sequence[torch.Tensor], group, nxt: int, prv: int
             ) -> List[torch.Tensor]:
    """:func:`exchange_start`, waited."""
    return exchange_start(payload, group, nxt, prv).wait()


def _bytes_view(x: torch.Tensor) -> torch.Tensor:
    """x's bytes as a uint8 tensor ``(x.shape[0], -1)``."""
    return x.contiguous().reshape(-1).view(torch.uint8).reshape(
        x.shape[0], -1)


def all_reduce_start(x: torch.Tensor, group, op: str = "sum") -> Pending:
    """Issue the sum (``op="sum"``) or max (``"max"``) of ``x`` over
    ``group``; ``wait()`` gives it in a new tensor: every member gets the
    same bytes."""
    staged = _staged(group, x)
    t0 = time.perf_counter()
    buf = _to_host([x])[0] if staged else x.clone()
    work = dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                           else dist.ReduceOp.SUM, group=group,
                           async_op=True)
    return _issue("all_reduce", x.numel() * x.element_size(), group, staged,
                  t0, [work], lambda: _back(buf, x.device, staged))


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """:func:`all_reduce_start`, waited."""
    return all_reduce_start(x, group, op).wait()


def all_gather_start(x: torch.Tensor, group, dim: int = 0) -> Pending:
    """Issue the gather of the members' ``x`` concatenated along ``dim`` in
    group-rank order (moved as bytes: any dtype)."""
    n = dist.get_world_size(group)
    staged = _staged(group, x)
    t0 = time.perf_counter()
    src = x.movedim(dim, 0).contiguous()
    b = _bytes_view(src)
    if staged:
        b = _to_host([b])[0]
    parts = [torch.empty_like(b) for _ in range(n)]
    work = dist.all_gather(parts, b, group=group, async_op=True)

    def finish():
        out = torch.cat(parts).view(src.dtype).reshape(
            (n * src.shape[0],) + src.shape[1:])
        return _back(out, x.device, staged).movedim(0, dim)

    return _issue("all_gather", x.numel() * x.element_size(), group, staged,
                  t0, [work], finish)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather_start`, waited."""
    return all_gather_start(x, group, dim).wait()


def all_to_all_start(x: torch.Tensor, group) -> Pending:
    """Issue a tiled all-to-all over ``group`` along axis 0: ``x`` is ``(n
    * c, ...)``; chunk j goes to member j, and the result's chunk j came
    from member j (JAX's ``all_to_all(x, axis, 0, 0, tiled=True)``). Moved
    as bytes, so any dtype crosses as it is."""
    staged = _staged(group, x)
    t0 = time.perf_counter()
    b = _bytes_view(x)
    if staged:
        b = _to_host([b])[0]
    out = torch.empty_like(b)
    work = dist.all_to_all_single(out, b, group=group, async_op=True)
    return _issue("all_to_all", x.numel() * x.element_size(), group, staged,
                  t0, [work], lambda: _back(
                      out.view(x.dtype).reshape(x.shape), x.device, staged))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_to_all_start`, waited."""
    return all_to_all_start(x, group).wait()


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of the members' ``x`` over ``group``, cut along ``dim`` into
    ``n`` parts in group-rank order; this member gets its part, summed in
    fp32 in group-rank order (the same bits on any member that would hold
    it) and returned in x's dtype. One tiled all-to-all (gloo has no
    reduce-scatter), counted as ``"reduce_scatter"``."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: axis {dim} of {tuple(x.shape)} "
                         f"does not split into {n}")
    staged = _staged(group, src)
    t0 = time.perf_counter()
    b = _bytes_view(src)
    if staged:
        b = _to_host([b])[0]
    out = torch.empty_like(b)
    work = dist.all_to_all_single(out, b, group=group, async_op=True)

    def finish():
        # the parts cross back one at a time: the card holds the fp32 sum
        # and one part, not all n
        parts = out.view(src.dtype).reshape(
            (n, src.shape[0] // n) + src.shape[1:])
        acc = _back(parts[0], x.device, staged).float()
        for j in range(1, n):
            acc += _back(parts[j], x.device, staged).float()
        return acc.to(x.dtype).movedim(0, dim)

    return _issue("reduce_scatter", x.numel() * x.element_size(), group,
                  staged, t0, [work], finish).wait()


# ---------------------------------------------------------------------------
# differentiable collectives (the training path)
# ---------------------------------------------------------------------------


def _needs_grad(xs) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in xs)


class _Collective(torch.autograd.Function):
    """A collective as an autograd node: ``fwd()`` gives its outputs (a
    tensor or a tuple), ``bwd(grads)`` the inputs' gradients (its
    transpose, run with the forward's layer and half tags and
    ``phase="bwd"``). ``inputs`` only link the node into the graph."""

    @staticmethod
    def forward(ctx, fwd, bwd, tags, keep, *inputs):
        ctx.bwd, ctx.tags = bwd, tags
        out = fwd()
        outs = out if isinstance(out, tuple) else (out,)
        if keep is None:
            keep = [o.is_floating_point() for o in outs]
        ctx.mark_non_differentiable(*[o for o, k in zip(outs, keep)
                                      if not k])
        return out

    @staticmethod
    def backward(ctx, *grads):
        with tagged(*ctx.tags, phase="bwd"):
            got = ctx.bwd(list(grads))
        return (None, None, None, None) + tuple(got)


def _apply(fwd, bwd, inputs, keep=None):
    """Run ``fwd`` plainly, or, where an input needs a gradient, as an
    autograd node whose backward is ``bwd``. ``keep``: per output, whether
    it is differentiable (default: every floating output)."""
    if not _needs_grad(inputs):
        return fwd()
    return _Collective.apply(fwd, bwd, (_TAG["layer"], _TAG["half"]),
                             None if keep is None else tuple(keep), *inputs)


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` (Megatron's ``g``): the row-parallel product's
    partials, the vocab-parallel embedding. The backward is the identity:
    the consumer of the sum is replicated over the group, so its gradient
    is each member's already. None: the identity."""
    if group is None:
        return x
    return _apply(lambda: all_reduce(x.detach(), group),
                  lambda g: [g[0]], [x])


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The identity into a region where each member computes its own part
    (Megatron's ``f``: a column-parallel product's replicated input, a
    replicated leaf used by this member's heads, the tokens an EP member
    takes its slice of). The backward sums the members' partial
    gradients over ``group`` in fp32. None: the identity."""
    if group is None or not _needs_grad([x]):
        return x

    def bwd(g):
        g0 = g[0]
        return [all_reduce(g0.float(), group).to(g0.dtype)]

    return _apply(lambda: x.view_as(x), bwd, [x])


def own_part(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This member's part of ``t`` cut along ``dim`` into the group's size
    (the backward of a gather whose consumer is replicated)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    per = t.shape[dim] // n
    return t.narrow(dim, me * per, per).contiguous()


def gather(x: torch.Tensor, group, dim: int = 0,
           backward: str = "slice") -> torch.Tensor:
    """:func:`all_gather` along ``dim``, differentiable. ``backward="slice"``:
    the consumer is replicated over the group (each member's gradient of
    the whole is the same), so this member's gradient is its slice of it;
    ``"reduce_scatter"``: each member's consumer is its own (a ZeRO-3
    weight gathered for this member's batch rows), so the members'
    gradients are summed (in fp32, :func:`reduce_scatter`) and cut. None:
    the identity."""
    if group is None:
        return x

    def bwd(g):
        g0 = g[0]
        if backward == "slice":
            return [own_part(g0, group, dim)]
        return [reduce_scatter(g0, group, dim).to(x.dtype)]

    return _apply(lambda: all_gather(x.detach(), group, dim), bwd, [x])


def split(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This member's part of ``x``, replicated over ``group``, cut along
    ``dim`` (:func:`own_part`), differentiable: each member's consumer is
    its own part, so the backward gathers the parts' gradients into the
    whole one on every member. None: the identity."""
    if group is None:
        return x
    return _apply(lambda: own_part(x.detach(), group, dim),
                  lambda g: [all_gather(g[0], group, dim)], [x])


def scatter_sum(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """:func:`reduce_scatter`, differentiable: the backward gathers the
    gradient's parts. None: the identity."""
    if group is None:
        return x
    return _apply(lambda: reduce_scatter(x.detach(), group, dim),
                  lambda g: [all_gather(g[0], group, dim)], [x])


def waited(pend: Pending, inputs: Sequence[torch.Tensor], bwd,
           keep: Optional[Sequence[bool]] = None, finish=None):
    """The result of an issued collective (``pend.wait()``, then
    ``finish`` of it if given: a tensor or a list), as an autograd node
    over the ``inputs`` it was issued with (their values were sent at the
    issue). ``bwd(grads)`` gives the inputs' gradients from the outputs'
    (None where an output got none): the collective's transpose. ``keep``:
    per output, whether it carries a gradient (default: every floating
    one)."""
    def fwd():
        out = pend.wait()
        if finish is not None:
            out = finish(out)
        return tuple(out) if isinstance(out, list) else out

    res = _apply(fwd, bwd, list(inputs), keep)
    return list(res) if isinstance(res, tuple) else res


def sharded_global_norm(tree, mesh, pspecs) -> torch.Tensor:
    """Global L2 norm of a sharded gradient tree (the reference's
    ``sharded_global_norm``): each rank's fp32 sum of squares of its
    leaves, each divided by the leaf's replication factor (the sizes of
    the mesh axes its PartitionSpec does not use: replicas hold the same
    bits, so each counts once), summed over every axis of the mesh. The
    sums are gathered and added in rank order, so every rank holds the
    same bits (the clip scale must not differ between replicas).
    ``tree`` and ``pspecs`` are nested dicts of the same keys; ``None``
    leaves add nothing."""
    from repro_torch.train.optimizer import tree_items
    specs = dict(tree_items(pspecs))
    total = None
    for path, g in tree_items(tree):
        if g is None:
            continue
        used = set()
        for e in specs[path]:
            if e is not None:
                used.update((e,) if isinstance(e, str) else e)
        r = 1
        for a in mesh.axis_names:
            if a not in used:
                r *= mesh.shape[a]
        s = torch.sum(g.float() ** 2) / float(r)
        total = s if total is None else total + s
    for a in mesh.axis_names:
        if mesh.shape[a] > 1:
            total = all_gather(total.reshape(1), mesh.groups[a]).sum(0)
    t = total.reshape(())
    # correctly rounded: the CPU's vectorized fp32 sqrt is not always
    return t.sqrt() if t.is_cuda else torch.sqrt(t.double()).float()


def drive(phases):
    """Run a phase generator to its end and return its value. A phase
    generator yields (None) each time it has issued a collective it will
    wait for after resuming, so that a scheduler may run other work there
    (``parallel/overlap.py`` runs two of them in turns); driven alone, each
    collective is waited for at once, as the plain call is."""
    while True:
        try:
            next(phases)
        except StopIteration as stop:
            return stop.value


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
