"""Parallel execution context — port of ``repro.parallel.context`` for
explicit SPMD on ``torch.distributed``: one process per mesh position.

Models are written once and consult this context to decide how to execute
(local vs expert-parallel MoE, the tensor-parallel collectives). The
serving engine (``serve/engine.ServeEngine(ctx=...)``) scopes its ctx
around every prefill and decode; without one, everything runs on a single
device.

The reference's ``Mesh`` is JAX's; the port keeps its own (:class:`Mesh`):
the axis names and sizes, this rank's coordinates, and the process group
of this rank's line along each axis. Ranks are laid out row-major over
the axes (``rank = d * |model| + m`` on ``("data", "model")``), and every
rank creates the group of every axis line, in the same order, as
``torch.distributed.new_group`` requires. A mesh with both data axes
(``("pod", "data", "model")``) also makes the group of each data plane,
the ranks that share every coordinate but the data axes', so that the
batch can be carried over the pair as one ``PartitionSpec`` entry
``("pod", "data")`` (major to minor: the pair's coordinate is ``pod *
|data| + data``, as JAX cuts it).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

AXES = ("data", "model")
# the axes that carry the batch, major to minor (the reference's
# ``dp_axes_for``): where a mesh has more than one, their plane is a group
DATA_AXES = ("pod", "data")


class Mesh:
    """A device mesh of ``torch.distributed`` ranks.

    ``shape`` maps each axis name to its size, in axis order (as
    ``jax.sharding.Mesh.shape``). A mesh made by :meth:`abstract` holds
    shapes only (enough for the sharding rules); one made by
    :meth:`create` also knows this process's position (``rank``), its
    coordinates, the group of each of its axis lines (``groups[axis]``)
    and of its data plane (``groups[("pod", "data")]``, where the mesh has
    both), and the default group's rank at each position (``ranks``)."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Sequence[str] = AXES, rank: Optional[int] = None,
                 groups: Optional[Dict[str, object]] = None,
                 ranks: Optional[Sequence[int]] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(n) for n in shape)))
        self.rank = rank
        self.groups = groups or {}
        # the default group's rank at each mesh position (create only)
        self.ranks = None if ranks is None else list(ranks)

    @classmethod
    def abstract(cls, shape: Sequence[int],
                 axis_names: Sequence[str] = AXES) -> "Mesh":
        return cls(shape, axis_names)

    @classmethod
    def create(cls, shape: Sequence[int],
               axis_names: Sequence[str] = AXES,
               ranks: Optional[Sequence[int]] = None) -> "Mesh":
        """The mesh over ``ranks`` of the initialized default process
        group (all of them by default; their count is the mesh size), mesh
        position i on ``ranks[i]``. Every rank of the default group calls
        it with the same arguments: each axis line's group is created on
        every rank, axis by axis, lines in row-major order of the other
        coordinates; then, on a mesh with more than one data axis
        (:data:`DATA_AXES`), each data plane's group, planes in row-major
        order of the other coordinates, members in pod-major order. A rank
        outside ``ranks`` gets a mesh without a position (``rank`` None)."""
        import torch.distributed as dist
        size = math.prod(shape)
        ranks = list(range(dist.get_world_size()) if ranks is None
                     else ranks)
        if len(ranks) != size:
            raise ValueError(f"mesh {tuple(shape)} needs {size} ranks; "
                             f"given {len(ranks)}")
        me = dist.get_rank()
        pos = ranks.index(me) if me in ranks else None
        groups = {}
        for a in range(len(shape)):
            others = [range(n) if i != a else [0]
                      for i, n in enumerate(shape)]
            for base in itertools.product(*others):
                line = []
                for j in range(shape[a]):
                    c = list(base)
                    c[a] = j
                    line.append(ranks[_rank_of(c, shape)])
                g = dist.new_group(line)
                if me in line:
                    groups[axis_names[a]] = g
        plane = data_axes(axis_names)
        if len(plane) > 1:
            ins = [axis_names.index(a) for a in plane]
            others = [range(n) if i not in ins else [0]
                      for i, n in enumerate(shape)]
            for base in itertools.product(*others):
                members = []
                for sub in itertools.product(*(range(shape[i]) for i in ins)):
                    c = list(base)
                    for i, j in zip(ins, sub):
                        c[i] = j
                    members.append(ranks[_rank_of(c, shape)])
                g = dist.new_group(members)
                if me in members:
                    groups[plane] = g
        return cls(shape, axis_names, pos, groups, ranks)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def coords(self) -> Dict[str, int]:
        if self.rank is None:
            raise ValueError("an abstract mesh has no rank")
        return dict(zip(self.axis_names,
                        _coords(self.rank, tuple(self.shape.values()))))

    def size_of(self, axes) -> int:
        """The number of positions along ``axes`` (an axis name, a tuple of
        them, or None: 1)."""
        return math.prod(self.shape[a] for a in _names(axes))

    def index_of(self, axes) -> int:
        """This rank's coordinate along ``axes``, row-major over a tuple
        (``pod * |data| + data`` for ``("pod", "data")``, as JAX cuts a
        ``PartitionSpec`` entry of that tuple)."""
        coords, i = self.coords, 0
        for a in _names(axes):
            i = i * self.shape[a] + coords[a]
        return i

    def group_of(self, axes):
        """The process group of this rank's line along ``axes`` (an axis
        name), or of its data plane (the tuple of :data:`DATA_AXES` on the
        mesh); None where it holds one position (nothing to exchange).
        Raises where the mesh has no such group on this rank (an abstract
        mesh, a rank off the mesh, or a tuple that is not the plane)."""
        names = _names(axes)
        if self.size_of(names) == 1:
            return None
        key = names[0] if len(names) == 1 else names
        if key not in self.groups:
            raise ValueError(
                f"no process group for {key!r} on this rank: the mesh is "
                "abstract, this rank is off it, or the axes are not a line "
                f"or the data plane {data_axes(self.axis_names)}")
        return self.groups[key]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def data_axes(axis_names: Sequence[str]) -> Tuple[str, ...]:
    """The data axes among ``axis_names``, major to minor (the
    reference's ``dp_axes_for``)."""
    return tuple(a for a in DATA_AXES if a in axis_names)


def _names(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _coords(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _rank_of(coords: Sequence[int], shape: Sequence[int]) -> int:
    r = 0
    for c, n in zip(coords, shape):
        r = r * n + c
    return r


REMAT = ("none", "full", "dots")


@dataclasses.dataclass
class ParallelCtx:
    """The reference's fields, with ``mesh`` the port's :class:`Mesh` (a
    shape tuple builds one over the default process group, axes
    ``("data", "model")``).

    ``remat`` (``none`` | ``full`` | ``dots``) checkpoints each layer step
    of the training forward (``models/api.remat``), with or without a
    mesh. ``seq_axis`` (the model axis, or None) cuts the training
    residual stream along the sequence between blocks (Megatron-style
    sequence parallelism: :func:`seq_group`). ``pin_attn`` is a GSPMD hint
    in the reference; explicit SPMD always computes a rank's heads from
    its own column slices, which is what ``pin_attn=True`` pins, so either
    value runs the same program. ``microbatches`` (2 or more: the meshed
    train step's dual microbatch) is read by ``train/trainer.py``.
    ``dp_axes`` may name both data axes, ``("pod", "data")``: the batch is
    then cut over the pair (:attr:`dp_group`, :attr:`dp_index`)."""
    mesh: Optional[Union[Mesh, Tuple[int, ...]]] = None
    dp_axes: Tuple[str, ...] = ("data",)   # axes carrying the batch dim
    ep_axis: Optional[str] = "model"       # axis carrying experts
    tp_axis: Optional[str] = "model"       # axis for tensor parallelism
    pod_axis: Optional[str] = None         # slow inter-pod axis (if any)
    moe_impl: str = "local"                # local | ep_flat | ep_dedup
    ep_ftp: bool = False                   # decode: expert-FF TP over data
    wire: str = "fp8"                      # EP dispatch wire: fp8|bf16|fp32
    remat: str = "none"                    # none | full | dots
    seq_axis: Optional[str] = None         # training sequence parallelism
    pin_attn: bool = True                  # GSPMD hint in the reference;
                                           # explicit SPMD holds its shards
    microbatches: int = 2                  # train step (paper §2.3.1)
    # the port's own: the meshed train step's ZeRO-3 plan for one loss
    # evaluation (``parallel/sharding.Zero3``; None: no gathering)
    zero3: Any = None
    # the port's own: whether the residual stream is cut along the
    # sequence right now (the training loss's backbone, through
    # :func:`sequence_sharded`; read by :func:`seq_group`)
    seq_on: bool = False

    def __post_init__(self):
        if self.remat not in REMAT:
            raise ValueError(f"remat={self.remat!r}: one of {REMAT}")
        if self.seq_axis is not None and self.seq_axis != self.tp_axis:
            raise ValueError(
                f"seq_axis={self.seq_axis!r}: the port cuts the sequence "
                f"over the tensor-parallel axis ({self.tp_axis!r}) only")
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            self.mesh = Mesh.create(tuple(self.mesh))

    @property
    def ep_enabled(self) -> bool:
        return self.mesh is not None and self.moe_impl != "local"

    @property
    def dp_size(self) -> int:
        """Total data-parallel degree (1 when unmeshed)."""
        if self.mesh is None:
            return 1
        n = 1
        for a in self.dp_axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def model_size(self) -> int:
        """Size of the model/TP axis (1 when unmeshed) — the EP degree of
        the serving deployment when ``ep_axis == tp_axis``."""
        if self.mesh is None or self.tp_axis is None:
            return 1
        return self.mesh.shape[self.tp_axis]

    # -- explicit SPMD: this rank's place on the mesh ------------------------
    def group(self, axes):
        """The process group of this rank's line along ``axes`` (an axis
        name), or of its data plane (``("pod", "data")``,
        ``Mesh.group_of``); None when unmeshed, for no axis, or where the
        axes hold one position (nothing to exchange)."""
        if self.mesh is None or axes is None:
            return None
        return self.mesh.group_of(axes)

    def index(self, axes) -> int:
        """This rank's coordinate along ``axes``, row-major over a tuple (0
        when unmeshed)."""
        if self.mesh is None or axes is None:
            return 0
        return self.mesh.index_of(axes)

    @property
    def tp_group(self):
        return self.group(self.tp_axis)

    @property
    def dp_group(self):
        """The group the batch is cut over: the data line, or the data
        plane of both data axes (members in pod-major order)."""
        return self.group(self.dp_axes)

    @property
    def dp_index(self) -> int:
        """This rank's part of the batch, of :attr:`dp_size`."""
        return self.index(self.dp_axes)


_CURRENT = ParallelCtx()


def get() -> ParallelCtx:
    return _CURRENT


def set_ctx(ctx: ParallelCtx) -> None:
    global _CURRENT
    _CURRENT = ctx


@contextlib.contextmanager
def use(ctx: Optional[ParallelCtx]):
    """Scope ``ctx`` (None: leave the current one) over a block."""
    global _CURRENT
    prev = _CURRENT
    if ctx is not None:
        _CURRENT = ctx
    try:
        yield _CURRENT
    finally:
        _CURRENT = prev


def shard_act(x, vocab_axis: bool = False):
    """The identity, kept for API parity with the reference; nothing in
    the port calls it. In the reference this pins an activation's GSPMD
    sharding (batch over the data axes, the sequence over ``seq_axis``,
    vocab over the model axis); under explicit SPMD every rank already
    holds its own shard, and the layers issue the collectives that move
    data (:func:`seq_group`)."""
    return x


def sequence_sharded(on: bool):
    """Scope whether the residual stream of the block is this rank's
    chunk of the sequence over ``seq_axis`` (the training loss's backbone
    when the sequence divides; prefill, decode and the MTP module run the
    whole sequence): the current ctx with ``seq_on`` set, under
    :func:`use`."""
    return use(dataclasses.replace(get(), seq_on=on))


def seq_group():
    """The process group the residual stream is cut over along the
    sequence (axis 1 of ``(B, S, d)``), or None: outside
    :func:`sequence_sharded`, without ``seq_axis``, unmeshed or on an axis
    of size 1. Under it the norms and residual adds run on this rank's
    chunk of tokens, a column-parallel input gathers the sequence and a
    row-parallel output reduce-scatters it (the reference's
    ``shard_act`` condition: ``x.ndim >= 3``, ``x.shape[1] > 1``,
    divisible, not the vocab output)."""
    c = get()
    if not c.seq_on or c.seq_axis is None:
        return None
    return c.group(c.seq_axis)


def seq_divides(ctx: ParallelCtx, seq_len: int) -> bool:
    """Whether ``ctx`` cuts a sequence of ``seq_len`` tokens: a
    ``seq_axis`` of size > 1 on the mesh that divides it."""
    if ctx.mesh is None or ctx.seq_axis is None:
        return False
    n = ctx.mesh.shape[ctx.seq_axis]
    return n > 1 and seq_len > 1 and seq_len % n == 0


def shard_heads(x):
    """The identity, kept for API parity with the reference; nothing in
    the port calls it. The reference's GSPMD hint pins (B, S, H, hd)
    attention tensors to batch x head sharding. Explicit SPMD computes
    each rank's heads from its own column slices of the projections."""
    return x
