"""Logical-axis -> mesh-axis sharding rules — port of
``repro.parallel.sharding``.

Param specs carry logical axes ("embed", "heads", "mlp", "vocab",
"experts", "layers"); a rule table maps them to mesh axes, with a
divisibility fallback (axes that don't divide evenly are replicated).
The spec functions return the port's :class:`PartitionSpec` — a tuple of
per-dimension mesh-axis entries, entry for entry the reference's
``jax.sharding.PartitionSpec`` — where the reference returns
``NamedSharding``s; trees are the port's nested dicts.

Explicit SPMD places data itself: :func:`shard_tree` cuts this rank's
slice of a global tree by its placements, the FP8 containers of
``core/fp8`` included (:func:`cut_blocks` is their rule: every cut of a
block-scaled axis falls on a 128 boundary or inside one 128 block).
:func:`explicit_cache_pspecs` is the port's cache placement: the
reference's, but for the dense rings, whose length axis stays whole on
each model column (GSPMD resolves a length-sharded softmax; explicit SPMD
would need a cross-rank one): the MLA latent ring replicates over the
model axis and the GQA ring shards its KV-head axis instead; and but for
the recurrent conv tails, which the reference replicates over the model
axis: a rank's tail holds its own channels (RG-LRU), or its heads' x
channels and then B and C whole (Mamba-2: a :class:`Tail` entry).

The train state (the explicit half of the reference's
``train_state_shardings``): :func:`train_pspecs` and :func:`shard_state`
cut the parameters and the AdamW state; under a ctx with a ZeRO-3 plan
(``ParallelCtx.zero3``, a :class:`Zero3`) the model gathers each leaf's
data cut (over ``data``, or over the pair ``("pod", "data")`` on a
multi-pod mesh) as it uses it (:func:`gathered`) and its gradient is
reduce-scattered back.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.core import paged as paged_mod
from repro_torch.core.fp8 import BLOCK, Fp8Experts, Fp8Weight, k_major
from repro_torch.models.param import ParamSpec
from repro_torch.parallel.context import Mesh, data_axes

Rule = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dimension mesh-axis entries (None, an axis name or a tuple of
    names), as ``jax.sharding.PartitionSpec(*entries)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Tail(str):
    """A PartitionSpec entry: the axis is cut over the mesh axis it names
    (it compares equal to the name) but for its last ``whole`` entries,
    which every rank holds after its part of the rest. Mamba-2's cached
    conv tail (x | B | C channels): a rank holds its heads' x channels,
    then B and C whole. A cut that is not a region of the global leaf
    (:func:`region_of` refuses it)."""

    def __new__(cls, axis: str, whole: int):
        t = super().__new__(cls, axis)
        t.whole = whole
        return t

    def __repr__(self) -> str:
        return f"Tail({str.__repr__(self)}, whole={self.whole})"

    def part(self, t, dim: int, n: int, idx: int):
        """Part ``idx`` of ``n`` of ``t`` along ``dim``."""
        cut = t.shape[dim] - self.whole
        return torch.cat([t.narrow(dim, idx * cut // n, cut // n),
                          t.narrow(dim, cut, self.whole)], dim=dim)

    def joined(self, parts, dim: int):
        """The global leaf from the ``n`` parts (in rank order) of
        :meth:`part`."""
        cut = parts[0].shape[dim] - self.whole
        return torch.cat([q.narrow(dim, 0, cut) for q in parts]
                         + [parts[0].narrow(dim, cut, self.whole)], dim=dim)


def tp_rules(multi_pod: bool) -> Dict[str, Rule]:
    return {
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_ff": "data",   # decode: expert-FF TP over data (ep_ftp)
        "layers": None,
    }


def dp_ep_rules(multi_pod: bool) -> Dict[str, Rule]:
    """Paper §4.2: no TP; experts EP-sharded; big dense weights FSDP over
    the data axis."""
    return {
        "embed": None,
        "heads": "data",
        "kv_heads": "data",
        "mlp": "data",
        "vocab": "model",
        "experts": "model",
        "layers": None,
    }


def fsdp_tp_rules(multi_pod: bool) -> Dict[str, Rule]:
    """Training rules: TP on the model axis + ZeRO-3/FSDP over the data
    axis for the big replicated dims."""
    return {
        "embed": ("pod", "data") if multi_pod else "data",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_ff": None,
        "layers": None,
    }


def rules_for(cfg, phase: str, multi_pod: bool) -> Dict[str, Rule]:
    if phase in ("train", "prefill"):
        return fsdp_tp_rules(multi_pod)
    return tp_rules(multi_pod)


def serve_rules(multi_pod: bool, ep_ftp: bool = False) -> Dict[str, Rule]:
    """Decode rules of the sharded serving engine: heads and dense matmuls
    TP over the model axis, experts EP on it; ``expert_ff`` takes its
    data-axis TP only under ``ep_ftp``."""
    r = tp_rules(multi_pod)
    if not ep_ftp:
        r["expert_ff"] = None
    return r


def _mesh_size(mesh: Mesh, rule: Rule) -> int:
    if rule is None:
        return 1
    if isinstance(rule, str):
        return mesh.shape[rule]
    return math.prod(mesh.shape[r] for r in rule)


def spec_to_pspec(spec: ParamSpec, mesh: Mesh,
                  rules: Dict[str, Rule]) -> PartitionSpec:
    entries = []
    used: set = set()
    for dim, ax in zip(spec.shape, spec.axes):
        rule = rules.get(ax) if ax is not None else None
        if rule is None:
            entries.append(None)
            continue
        names = (rule,) if isinstance(rule, str) else tuple(rule)
        if any(n in used for n in names) or dim % _mesh_size(mesh, rule) != 0:
            entries.append(None)   # replicate: non-divisible or axis reuse
            continue
        used.update(names)
        entries.append(rule)
    return P(*entries)


def map_with_path(fn: Callable, tree, path=()):
    """``fn(path, leaf)`` over nested dicts (path: the keys down to it)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(mesh: Mesh, spec_tree, rules: Dict[str, Rule]):
    """PartitionSpec tree of a ParamSpec tree (same nesting)."""
    return map_with_path(lambda _, s: spec_to_pspec(s, mesh, rules), spec_tree)


def train_state_shardings(mesh: Mesh, spec_tree, rules: Dict[str, Rule]):
    """The placement half of the reference's ``train_state_shardings``:
    ``(param pspecs, AdamWState of pspecs, pspecs)``. The fp32 master and
    the m/v moments mirror the parameters (every parameter of the port is
    floating); the step counter replicates."""
    from repro_torch.train.optimizer import AdamWState
    pspecs = param_pspecs(mesh, spec_tree, rules)
    return pspecs, AdamWState(P(), pspecs, pspecs, pspecs), pspecs


def batch_pspec(mesh: Mesh, batch_size: int, dp_axes: Tuple[str, ...],
                ndim: int = 2, seq_axis: Optional[str] = None
                ) -> PartitionSpec:
    """Shard the batch dim over dp axes when divisible; optionally shard
    the sequence dim."""
    total = math.prod(mesh.shape[a] for a in dp_axes)
    entries: list = [None] * ndim
    if batch_size % total == 0:
        entries[0] = tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]
    elif seq_axis and ndim >= 2:
        entries[1] = seq_axis
    return P(*entries)


# ---------------------------------------------------------------------------
# Decode-cache sharding: leaf-name-driven
# ---------------------------------------------------------------------------

_CACHE_AXES = {
    # name: (batch_axis_from_end, model_axis_from_end)
    "k": (-4, -3), "v": (-4, -3),          # (..., B, T, KV, hd): shard T
    "ckv": (-3, -2), "kr": (-3, -2),       # (..., B, T, R): shard T
    "pos": (-2, -1),                        # (..., B, T)
    "state": (-4, -3),                      # (..., B, H, P, N): shard heads
    "h": (-2, -1),                          # (..., B, w): shard width
    "conv": (-3, None),
    "memory": (0, None),
    "mtp_h": (0, None),
}


def _dp_entry(dp_axes):
    return tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]


def _ring_entries(name, shape, dp_total, msize, dp_axes, model_axis):
    ndim = len(shape)
    entries: list = [None] * ndim
    rule = _CACHE_AXES.get(name)
    if rule is None:
        return entries
    baxis, maxis = rule
    baxis = baxis % ndim
    if shape[baxis] % dp_total == 0:
        entries[baxis] = _dp_entry(dp_axes)
    if maxis is not None:
        maxis = maxis % ndim
        if maxis != baxis and shape[maxis] % msize == 0 and \
                shape[maxis] >= msize:
            entries[maxis] = model_axis
    return entries


def cache_pspecs(cache_structs, mesh: Mesh, dp_axes: Tuple[str, ...],
                 model_axis: str = "model"):
    """Dense decode caches: batch over dp axes (when divisible), the long
    axis (cache length) over the model axis (the reference's layout)."""
    dp_total = math.prod(mesh.shape[a] for a in dp_axes)
    msize = mesh.shape[model_axis]
    return map_with_path(lambda path, leaf: P(*_ring_entries(
        path[-1], tuple(leaf.shape), dp_total, msize, dp_axes, model_axis)),
        cache_structs)


def paged_cache_pspecs(cache_structs, mesh: Mesh, dp_axes: Tuple[str, ...],
                       model_axis: str = "model"):
    """A paged decode cache: pool leaves carry no batch axis and follow
    ``core/paged.pool_model_axes`` (GQA K/V shard their KV-head axis);
    the page table replicates; the slot-resident MTP hidden shards its
    batch over dp and the MTP ring takes the dense rules."""
    dp_total = math.prod(mesh.shape[a] for a in dp_axes)
    msize = mesh.shape[model_axis]

    def one(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        entries: list = [None] * len(shape)
        if name in ("memory", "mtp_h"):
            if shape[0] % dp_total == 0 and shape[0] > 0:
                entries[0] = _dp_entry(dp_axes)
            return P(*entries)
        if name == "page_table":
            return P()
        if "mtp" in path:
            return P(*_ring_entries(name, shape, dp_total, msize, dp_axes,
                                    model_axis))
        ax = paged_mod.pool_model_axes(name, len(shape))
        if ax is not None and shape[ax] % msize == 0 and shape[ax] >= msize:
            entries[ax] = model_axis
        return P(*entries)

    out = map_with_path(one, cache_structs)
    if isinstance(out, dict) and "page_table" in out:
        # every model column must see the identical full slot->page
        # mapping (copy-on-write prefix sharing aliases rows across slots)
        assert out["page_table"] == P(), out["page_table"]
    return out


def tier_payload_pspecs(payload_structs, mesh: Mesh,
                        model_axis: str = "model"):
    """A KV-tier page payload (``Model.gather_pages`` output): the pool
    leaf's rule (``core/paged.pool_model_axes``) applies verbatim."""
    msize = mesh.shape[model_axis]

    def one(path, leaf):
        shape = tuple(leaf.shape)
        entries: list = [None] * len(shape)
        ax = paged_mod.pool_model_axes(path[-1], len(shape))
        if ax is not None and shape[ax] % msize == 0 and shape[ax] >= msize:
            entries[ax] = model_axis
        return P(*entries)

    return map_with_path(one, payload_structs)


_STATE_BATCH_KEYS = ("tokens", "positions", "active", "left", "eos",
                     "tix")


def decode_state_shardings(mesh: Mesh, batch: int,
                           dp_axes: Tuple[str, ...]) -> Dict[str, Any]:
    """Per-slot decode-state vectors shard over the dp axes (when
    divisible); the draft counters replicate."""
    bshard = batch_pspec(mesh, batch, dp_axes, ndim=1)
    out = {k: (bshard if k in _STATE_BATCH_KEYS else P())
           for k in _STATE_BATCH_KEYS + ("drafts", "accepted")}
    out["rngs"] = batch_pspec(mesh, batch, dp_axes, ndim=2, seq_axis=None)
    return out


def input_shardings(mesh: Mesh, input_structs, dp_axes: Tuple[str, ...],
                    model_axis: str = "model"):
    """The model input dict (tokens/labels/embeds/cache)."""
    out = {}
    for k, v in input_structs.items():
        if k == "cache":
            out[k] = cache_pspecs(v, mesh, dp_axes, model_axis)
        else:
            out[k] = batch_pspec(mesh, v.shape[0], dp_axes, len(v.shape),
                                 seq_axis=None)
    return out


def explicit_cache_pspecs(cache_structs, mesh: Mesh,
                          dp_axes: Tuple[str, ...], model_axis: str = "model",
                          paged: bool = False):
    """The port's cache placement (module docstring): the reference's
    (:func:`cache_pspecs` or :func:`paged_cache_pspecs`), with each dense
    ring's length axis whole — the model axis moves to a GQA ring's
    KV-head axis where it divides, and off the MLA latent ring — and each
    recurrent conv tail cut as its state is: an RG-LRU tail by channels
    beside ``h``, a Mamba-2 tail by heads beside ``state`` (a :class:`Tail`
    whose ``whole`` entries are B and C)."""
    ref = (paged_cache_pspecs if paged else cache_pspecs)(
        cache_structs, mesh, dp_axes, model_axis)
    msize = mesh.shape[model_axis]

    def one(path, leaf):
        spec = list(at_path(ref, path))
        name = path[-1]
        if name == "conv":
            return P(*_conv_entries(spec, at_path(cache_structs, path[:-1]),
                                    at_path(ref, path[:-1]), model_axis))
        ring = name in ("k", "v", "ckv", "kr", "pos") and (
            not paged or "mtp" in path)
        if not ring or model_axis not in spec:
            return P(*spec)
        spec[spec.index(model_axis)] = None
        if name in ("k", "v") and leaf.shape[-2] % msize == 0:
            spec[len(spec) - 2] = model_axis
        return P(*spec)

    return map_with_path(one, cache_structs)


def _conv_entries(spec, leaves, specs, model_axis):
    """A conv tail's entries (``(..., B, K-1, C)``) from its sibling
    state's cut: beside an RG-LRU ``h`` cut by width, the channels over
    the model axis; beside a Mamba-2 ``state`` cut by heads, the x
    channels of ``H * P`` by heads and the B and C channels whole."""
    if "h" in specs and model_axis in specs["h"]:
        spec[-1] = model_axis
    elif "state" in specs and model_axis in specs["state"]:
        H, Pd = leaves["state"].shape[-3:-1]
        spec[-1] = Tail(model_axis, leaves["conv"].shape[-1] - H * Pd)
    return spec


def at_path(tree, path):
    """The node of a nested dict at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# Explicit placement: this rank's slice of a global tree
# ---------------------------------------------------------------------------


def _parts(mesh: Mesh, entry) -> Tuple[int, int]:
    """(number of parts, this rank's part) of one pspec entry."""
    if entry is None:
        return 1, 0
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    n, idx = 1, 0
    coords = mesh.coords
    for a in names:
        n *= mesh.shape[a]
        idx = idx * mesh.shape[a] + coords[a]
    return n, idx


def region_of(shape, pspec, mesh: Mesh) -> Tuple[Tuple[int, int], ...]:
    """This rank's ``(start, stop)`` along each axis of a global leaf."""
    out = []
    if any(isinstance(e, Tail) for e in pspec):
        raise ValueError(f"{pspec}: a Tail cut is not a region of the "
                         "global leaf")
    for i, n_dim in enumerate(shape):
        n, idx = _parts(mesh, pspec[i] if i < len(pspec) else None)
        per = n_dim // n
        out.append((idx * per, (idx + 1) * per))
    return tuple(out)


def local_shape(shape, pspec, mesh: Mesh) -> Tuple[int, ...]:
    out = list(shape)
    for i, e in enumerate(pspec):
        n, _ = _parts(mesh, e)
        w = e.whole if isinstance(e, Tail) else 0
        out[i] = (out[i] - w) // n + w
    return tuple(out)


def cut_blocks(size: int, parts: int, index: int,
               block: int = BLOCK) -> Tuple[int, int]:
    """``(first block, blocks)`` of part ``index`` of ``parts`` along an
    axis of ``size`` quantized in ``block``s: a cut on block boundaries
    keeps its own blocks; a part inside one block keeps that block's
    scale. Any other cut raises: its codes would need scales the global
    quantization never made."""
    per = size // parts
    if per % block == 0:
        return index * per // block, per // block
    for j in range(parts):
        s = j * per
        if s // block != (s + per - 1) // block:
            raise ValueError(
                f"a cut of {size} into {parts} parts of {per} crosses a "
                f"{block}-block boundary: FP8 block scales cannot follow it")
    return index * per // block, 1


def _slice(t: torch.Tensor, dim: int, n: int, idx: int) -> torch.Tensor:
    per = t.shape[dim] // n
    return t.narrow(dim, idx * per, per)


def _cut_fp8_weight(w: Fp8Weight, pspec, mesh: Mesh) -> Fp8Weight:
    wt, wq, ws = w.w, w.wq, w.ws
    nd = wt.dim()
    for d, e in enumerate(pspec):
        n, idx = _parts(mesh, e)
        if n == 1:
            continue
        wt = _slice(wt, d, n, idx)
        wq = _slice(wq, d, n, idx)
        if d >= nd - 2:
            b0, nb = cut_blocks(w.w.shape[d], n, idx)
            ws = ws.narrow(d, b0, nb)
        else:
            ws = _slice(ws, d, n, idx)
    return Fp8Weight(wt.clone(), k_major(wq), ws.clone())


def _cut_fp8_experts(w: Fp8Experts, pspec, mesh: Mesh) -> Fp8Experts:
    """This rank's slice of stacked expert codes. The expert (and layer)
    axes slice as they are; a cut of the matrix's D or F axis (``ep_ftp``'s
    expert-FF cut over ``data``) keeps whole 128x128 code blocks and their
    scales, so each part must be a multiple of 128 (else ``ValueError``)."""
    lead = len(w.wq.shape) - 4
    wq, ws = w.wq, w.ws
    size = {lead: w.d_in, lead + 1: w.d_out}
    for d, e in enumerate(pspec):
        n, idx = _parts(mesh, e)
        if n == 1:
            continue
        if d < lead:
            wq = _slice(wq, d, n, idx)
            ws = _slice(ws, d, n, idx)
            continue
        per = size[d] // n
        if per % BLOCK:
            raise ValueError(
                f"a cut of an expert matrix's {size[d]} into {n} parts of "
                f"{per} is not whole {BLOCK}-blocks: its E4M3 code blocks "
                "cannot follow it")
        b0, nb = idx * per // BLOCK, per // BLOCK
        # wq is (..., FB, KB, 128, 128), ws (..., KB, FB)
        qd, sd = (lead + 1, lead) if d == lead else (lead, lead + 1)
        wq = wq.narrow(qd, b0, nb)
        ws = ws.narrow(sd, b0, nb)
        size[d] = per
    return Fp8Experts(wq.clone(), ws.clone(), w.dtype, size[lead],
                      size[lead + 1])


def cut_leaf(leaf, pspec, mesh: Mesh):
    """This rank's slice of one global leaf (a copy; replicated leaves are
    returned as they are)."""
    if all(e is None for e in pspec):
        return leaf
    if isinstance(leaf, Fp8Weight):
        return _cut_fp8_weight(leaf, pspec, mesh)
    if isinstance(leaf, Fp8Experts):
        return _cut_fp8_experts(leaf, pspec, mesh)
    out = leaf
    for d, e in enumerate(pspec):
        n, idx = _parts(mesh, e)
        if n > 1:
            out = (e.part(out, d, n, idx) if isinstance(e, Tail)
                   else _slice(out, d, n, idx))
    return out.clone()


def shard_tree(tree, pspecs, mesh: Mesh):
    """This rank's slice of a global tree (nested dicts; leaves tensors or
    the FP8 containers), by a same-nested tree of PartitionSpecs. Leaves
    without a pspec (the ``prepared`` marks) pass through."""
    def one(path, leaf):
        try:
            spec = at_path(pspecs, path)
        except (KeyError, TypeError):
            return leaf
        return cut_leaf(leaf, spec, mesh)

    return map_with_path(one, tree)


# subtrees whose weights may be block-quantized (the FP8 linears, the
# routed and shared experts); the embedding tables never are
_FP8_SUBTREES = ("attn", "mlp", "mtp", "moe")


def block_cuts_ok(spec_tree, pspecs, mesh: Mesh) -> bool:
    """Whether every cut of the matrix axes of every weight that may be
    block-quantized falls on 128 boundaries, so that the block
    quantization of a rank's slice is the slice of the global one."""
    ok = [True]

    def one(path, spec):
        if not any(s in path for s in _FP8_SUBTREES):
            return spec
        pspec = at_path(pspecs, path)
        for d in range(max(0, len(spec.shape) - 2), len(spec.shape)):
            n = _mesh_size(mesh, pspec[d])
            if n > 1 and (spec.shape[d] // n) % BLOCK:
                ok[0] = False
        return spec

    map_with_path(one, spec_tree)
    return ok[0]


# ---------------------------------------------------------------------------
# The train state under explicit SPMD: FSDP (ZeRO-3) over the data axis
# ---------------------------------------------------------------------------


def whole_heads(cfg, mesh: Mesh, spec_tree, pspecs):
    """``pspecs`` with every head cut dropped where it would split a head:
    a ``heads`` cut where ``cfg.num_heads`` is not a multiple of it (GQA:
    each rank then runs every head, the attention replicated over the
    model axis), a ``kv_heads`` cut where ``cfg.num_kv_heads`` is not, or
    where the query heads stay whole (each rank then reads the KV heads of
    its own query heads). Layout differences against the reference's
    GSPMD placement, which cuts inside a head (ROADMAP.md §A)."""
    def splits(entry, count):        # a cut of ``count`` heads inside one
        return entry is not None and count % _mesh_size(mesh, entry)

    def one(path, spec):
        ps = list(at_path(pspecs, path))
        for i, ax in enumerate(spec.axes):
            if ax == "heads" and splits(ps[i], cfg.num_heads):
                if cfg.attention == "mla":
                    raise NotImplementedError(
                        f"{cfg.num_heads} MLA heads do not split over "
                        f"{_mesh_size(mesh, ps[i])} model columns")
                ps[i] = None
            elif ax == "kv_heads" and (splits(ps[i], cfg.num_kv_heads)
                                       or splits(ps[i], cfg.num_heads)):
                ps[i] = None
        return P(*ps)

    return map_with_path(one, spec_tree)


def train_pspecs(mesh: Mesh, spec_tree, cfg=None):
    """The parameters' training placements (``fsdp_tp_rules``: ``embed``
    over ``data``, or over ``("pod", "data")`` where the mesh has a pod
    axis, as the reference's trainer reads ``multi_pod``; heads, mlp,
    vocab and experts over ``model``); given ``cfg``, with every head kept
    whole (:func:`whole_heads`)."""
    ps = param_pspecs(mesh, spec_tree,
                      fsdp_tp_rules("pod" in mesh.axis_names))
    return ps if cfg is None else whole_heads(cfg, mesh, spec_tree, ps)


def shard_state(state, pspecs, mesh: Mesh):
    """This rank's slice of an ``AdamWState`` (fp32 master, bf16 m and v by
    the parameters' placements; the step counter replicated)."""
    return type(state)(state.step, shard_tree(state.master, pspecs, mesh),
                       shard_tree(state.m, pspecs, mesh),
                       shard_tree(state.v, pspecs, mesh))


def data_dim(pspec, axes) -> Optional[int]:
    """The dimension a PartitionSpec cuts over the data axes ``axes`` (one
    axis, or the pair ``("pod", "data")`` as one tuple entry); None where
    it replicates over them. A cut over some of them alone, or over one of
    them with another axis, raises: no data group gathers it."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    for d, e in enumerate(pspec):
        got = (e,) if isinstance(e, str) else tuple(e or ())
        if got == names:
            return d
        if set(got) & set(names):
            raise ValueError(f"a dimension cut over {e}: the data cut is "
                             f"over {names}")
    return None


class Zero3:
    """A rank's ZeRO-3 plan for one loss evaluation: the training
    placements of the parameter tree and the mesh. :meth:`take` gathers
    the data cut of each leaf of a subtree before its use, over the data
    axes ``axes`` (by default the mesh's: ``data``, or the pair ``("pod",
    "data")``, whose group concatenates in pod-major order)
    (``collectives.gather(..., backward="reduce_scatter")``: the backward
    reduce-scatters the leaf's gradient over them, which is also its
    data-axis reduction). The model gathers one layer at a time, as it
    reaches it (``Model._run_segment``, ``overlap._dual_segments``; the
    embedding and the MTP module once per evaluation); a subtree taken
    again in the same evaluation is the same gathered tensors. The
    backward does not re-gather: autograd keeps each gathered weight for
    its products' backward, so a rank holds every gathered layer (its
    model column's cut, whole along ``data``) from its use to the end of
    the backward. Leaves that replicate over the data axes pass through;
    the train step all-reduces their gradients over them."""

    def __init__(self, mesh: Mesh, pspecs, axes=None):
        self.mesh, self.pspecs = mesh, pspecs
        self.axes = data_axes(mesh.axis_names) if axes is None else axes
        self.group = mesh.group_of(self.axes)
        self._taken: Dict[Tuple, Any] = {}

    def take(self, tree, path: Tuple[str, ...], index: Optional[int] = None):
        """``tree`` (the subtree at ``path``, or layer ``index`` of it)
        with its data-cut leaves gathered."""
        key = (path, index)
        if key in self._taken:
            return self._taken[key]
        from repro_torch.parallel import collectives as coll
        lead = 0 if index is None else 1

        def one(sub, leaf):
            spec = at_path(self.pspecs, path + sub)
            d = data_dim(tuple(spec)[lead:], self.axes)
            if d is None or self.group is None:
                return leaf
            return coll.gather(leaf, self.group, d, backward="reduce_scatter")

        out = map_with_path(one, tree)
        self._taken[key] = out
        return out


def gathered(tree, path: Tuple[str, ...], index: Optional[int] = None):
    """The parameters at ``path`` (layer ``index`` of a stacked subtree)
    as the model uses them: under a ctx with a ZeRO-3 plan
    (``ParallelCtx.zero3``, a :class:`Zero3`) with their data cuts
    gathered, else as they are."""
    from repro_torch.models.param import layer
    from repro_torch.parallel.context import get
    sub = tree if index is None else layer(tree, index)
    plan = get().zero3
    return sub if plan is None else plan.take(sub, path, index)


def check_fp8_train_cuts(spec_tree, pspecs, mesh: Mesh,
                         min_k: int = 256) -> None:
    """Training quantizes each FP8 linear's weight on its rank in 128x128
    blocks (the reference quantizes the whole weight). Raise unless every
    model-axis cut of an FP8 linear's matrix (a 2-D weight a layer under
    attn/mlp/mtp whose input width reaches the FP8 path) falls on 128
    boundaries, so that a rank's blocks are the single device's. Data
    cuts (over ``data`` or the pair ``("pod", "data")``) are gathered
    before use (:class:`Zero3`)."""
    def one(path, spec):
        if not any(s in path for s in ("attn", "mlp", "mtp")):
            return spec
        if len(spec.shape) != 3 or spec.shape[1] < min_k:
            return spec
        pspec = at_path(pspecs, path)
        for d in (1, 2):
            e = pspec[d] if d < len(pspec) else None
            if e is None or e in ("data", ("pod", "data")):
                continue
            n = _mesh_size(mesh, e)
            if n > 1 and (spec.shape[d] // n) % BLOCK:
                raise ValueError(
                    f"{'/'.join(path)} {spec.shape}: its cut over {e} gives "
                    f"{spec.shape[d] // n} a rank, not whole 128-blocks; "
                    "its FP8 blocks would differ from the single device's")
        return spec

    map_with_path(one, spec_tree)
