"""Serving engine — port of ``repro.serve.engine.ServeEngine`` for
single-device serving (paper §2.1.2 quantized latent cache, §2.3.2
memory-bound decode, §2.3.3 MTP drafting), of every config of the
reference (MLA, GQA, the recurrent, enc-dec and vision families), over
either cache layout (the recurrent and vision families: dense only):

* dense (``paged=False``, the default): every slot owns a ring of
  ``max_len`` rows per attention layer. Admission is bucketed prefill
  (``Model.prefill`` with ``extra_slots`` up to ``max_len``) spliced into
  the slot; a request needs only a free slot.
* paged (``paged=True``): one shared pool of fixed-size token pages per
  attention segment and per-slot page tables. A request reserves
  ``ceil((prompt + max_new) / page_size)`` pages and admits when a slot
  *and* its pages are free: bucketed prefill -> ``prefill_to_pages``
  (E4M3 values + per-token scales under ``page_storage="fp8"``) ->
  ``admit_pages``. A freed slot's pages return to the pool and its table
  row points at the trash page, so its masked decode lane never writes
  into recycled pages.

With ``prefill_chunk`` (paged engines) the engine is the reference's
continuous-batching scheduler:

* a prompt streams into its slot's pages in page-aligned chunks of
  ``prefill_chunk`` tokens (``Model.prefill_chunk``), one chunk of the
  lowest prefilling slot per tick, between decode chunks; the slot's
  table row stays at the trash page and its lane out of the decode chunk
  until its last chunk samples the first token;
* full prompt pages are indexed by their token prefix, and a later
  request claims the indexed run copy-on-write (shared pages are never
  written again; fresh pages take over at the divergence point).

Every engine admits in priority order, FIFO within a class, and a blocked
arrival preempts a strictly lower-priority resident: the victim returns to
the queue as a continuation (prompt + delivered tokens, remaining budget,
advanced stream index), so its stream is the one it would have made
uninterrupted; under chunked prefill it keeps its written prefix pages
for its resume. ``cancel(rid)`` frees a request in any state.

With ``host_tier_pages`` (paged engines) the device pool is a cache over a
host-memory page tier (paper §4.5's memory hierarchy;
``core/paged.HostPageTier``, ``serve/tier.py``): a preempted resident, or
one whose decode quantum expired while others wait, is *suspended* — its
pages and slot-resident aux leaves are gathered and staged to the host,
each page with a CRC32, its table row goes to the trash page at once and
its lane leaves the decode chunk — and resumes, without recompute, once
its pages are fetched back and a slot frees. Cold refcount-0 prefix pages
spill ahead of reuse and come back through admission's tier probe. The
reference's tick-clocked transfer model (``TransferClock``) decides when a
transfer lands, can drop or stretch it under injected faults
(``tier_faults``), and a failure walks the reference's degradation
ladder: a failed spill resumes in place, a failed or corrupted fetch
re-queues the request as a continuation.

``step()`` then runs ``chunk`` fused decode steps (``Model.decode_loop``,
with the same-step MTP draft under ``use_mtp``) over the decoding slots
and reads the emitted tokens, the slot state and the draft counters back
in one copy per chunk. On the card the decode chunk and the prefill chunk
are one CUDA graph each, captured on the engine's second chunk of each
kind and replayed after (``serve/graph.py``, the counterparts of the
reference's jitted ``decode_chunk`` and ``chunk_prefill``); a prefill
chunk crosses in one non-blocking copy and reads nothing back but the
last chunk's first token. On the CPU both run eagerly.

``ctx=`` (a ``parallel.context.ParallelCtx`` with a mesh) makes the
engine one rank of a mesh-sharded deployment, in explicit SPMD: every
rank of the mesh builds the same engine and runs the same host scheduler
on the same requests. Params are this rank's slices per
``sharding.serve_rules`` (heads and dense matmuls tensor-parallel over
the model axis, experts expert-parallel on it, the rest replicated), the
caches per ``sharding.explicit_cache_pspecs`` (slots over the data axes,
the data line or the pair ``("pod", "data")`` of a multi-pod mesh; the
page pool replicated over them, GQA K/V pools over the model axis, the
recurrent states and conv tails by heads or channels), and a data row
decodes only its own slots: after each decode chunk the sampled tokens,
slot state and MTP counters are gathered over the data axes, so every
rank's host mirrors are whole. Prefill of one prompt is
replicated over the data rows, as the reference's. A meshed engine on a
gloo group runs its decode chunk eagerly (a collective staged through
host memory cannot be captured; ``trace_counts["decode"] == 0``); its
kernels launch as on one device. Every family serves under a mesh: the
dense/MoE pairs, the recurrent families (dense cache: their blocks
tensor-parallel by heads or channels, ``models/ssm.py``,
``models/rglru.py``) and the families with a memory (the ``memory``
leaf replicated over the model axis).

Under a mesh the scheduler and the tier run identically on every rank
from the replicated host mirrors. A prefill chunk is one slot's prompt,
replicated over the data rows (each runs it on its own replica of the
pool, so the pools stay byte-equal) and cut over the model axis as a
whole prompt's prefill is; it runs eagerly, as the meshed decode chunk
does (``trace_counts["chunk"] == 0``). Each rank spills, stages, checks
and installs its own cut of a slot's pages (the pools' placement: GQA
K/V by KV heads, the rest whole); the slot's aux leaves travel from the
data row that owns the slot to every rank. A page CRC reads this rank's
bytes only, so each fetch agrees on its verdict over the mesh before any
rank installs or degrades; the byte counters and the transfer clock read
the whole payload's bytes, the reference's figures.

A request of the enc-dec or vision family carries ``extras``
(``src_embeds`` frames, or a ready ``memory``; ``patch_embeds``): its
prefill runs the encoder (enc-dec) and writes the memory into the slot's
slot-resident ``memory`` leaf, zero-padded past the request's rows, as
the reference's splice; every decode step attends over the whole leaf.
The engine keeps each slot's extras, so a preempted request re-prefills
with them and a suspended one takes them to the tier with its memory
rows. Chunked admission refuses extras, as the reference's.

``decode_overlap=True`` runs the decode chunk as two anti-phase
half-batches of the slots (``Model.decode_loop(overlap=True)``,
``parallel/overlap.py``): under a mesh with EP each half's dispatch and
combine are in flight while the other half computes (paper §2.3.1). A
dense cache, no MTP and an even slot count (on each data row, under a
mesh), as the reference asks; on the card the unmeshed dual chunk is one
CUDA graph as the single one is. It never falls back to the single path.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import prepare_for_serving
from repro_torch.configs.base import ModelConfig
from repro_torch.core import paged as paged_mod
from repro_torch.models.api import Model, sample_logits
from repro_torch.models.param import init_params
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import context as pctx_mod
from repro_torch.serve import tier as tier_mod
from repro_torch.serve.graph import DecodeChunk, PrefillChunk

# Smallest prefill bucket: prompts shorter than this share one shape.
MIN_BUCKET = 8

# Admission skip-ahead starvation guard: how many times smaller requests
# may jump a page-blocked head before the head gets the next freed pages.
STARVATION_LIMIT = 8


class AdmissionError(RuntimeError):
    """Typed capacity rejection: no free slot/page for immediate admission,
    or the bounded pending queue is full."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int = 16            # new tokens after the prompt (the
                                 # prefill-produced first token counts)
    eos: Optional[int] = None
    seed: Optional[int] = None   # per-request sampling seed: token t of
                                 # the stream is drawn from (seed, t)
                                 # whatever slot runs it (None = engine
                                 # generator)
    sample_offset: int = 0       # stream index of the first token this
                                 # admission produces (continuations)
    priority: int = 0            # higher admits first and may preempt a
                                 # strictly lower resident; FIFO within a
                                 # class
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def bucket_length(length: int, max_len: int,
                  min_bucket: int = MIN_BUCKET) -> int:
    """Next power-of-two bucket for a prompt length, capped at ``max_len``."""
    if length > max_len:
        raise ValueError(f"prompt length {length} exceeds max_len {max_len}")
    b = min_bucket
    while b < length:
        b *= 2
    return min(b, max_len)


def _splice(big, small, slot: int, axes) -> None:
    """Write a batch-1 cache tree into slot ``slot`` of the batch cache, in
    place. ``axes`` is the model-declared batch-axis tree
    (``Model.cache_batch_axes``); length axes shorter than the batch
    buffer are padded (positions with -1, so decode masks them, values
    with 0)."""
    if isinstance(big, dict):
        for k in big:
            _splice(big[k], small[k], slot, axes[k])
        return
    if small.shape[axes] != 1:
        raise ValueError(f"_splice: prefill leaf batch axis {axes} has size "
                         f"{small.shape[axes]}; expected 1 (shapes "
                         f"{tuple(small.shape)} vs {tuple(big.shape)})")
    dst = big.select(axes, slot)
    src = small.select(axes, 0)
    if src.shape != dst.shape:
        dst.fill_(-1 if not src.dtype.is_floating_point else 0)
        dst = dst[tuple(slice(0, n) for n in src.shape)]
    dst.copy_(src)


def validate_request(req: Request, max_len: int, page_size: int,
                     pool_pages: int) -> None:
    """A paged engine's admission limits: the request fits ``max_len``
    (the paged cache never ring-wraps) and the pool."""
    if len(req.prompt) + req.max_new > max_len:
        raise ValueError(
            f"request {req.rid}: prompt ({len(req.prompt)}) + max_new "
            f"({req.max_new}) exceeds max_len ({max_len}); the paged cache "
            "never ring-wraps")
    need = paged_mod.pages_for(len(req.prompt) + req.max_new, page_size)
    if need > pool_pages:
        raise ValueError(f"request {req.rid}: needs {need} pages but the "
                         f"pool only has {pool_pages}")


def _slot_slice(cache, slot: int, axes):
    """Slot ``slot`` of the batch leaves named by ``axes`` as a batch-1
    tree of views — the inverse of :func:`_splice`. The tier's suspension
    stages the slot's aux leaves (the MTP hidden and ring) with its
    pages."""
    if isinstance(axes, dict):
        return {k: _slot_slice(cache[k], slot, axes[k]) for k in axes}
    return cache.narrow(axes, slot, 1)


def serve_param_pspecs(cfg: ModelConfig, ctx, specs):
    """``sharding.param_pspecs`` under ``serve_rules`` for ``ctx``'s mesh,
    with the layouts explicit SPMD needs: heads kept whole
    (``sharding.whole_heads``: a GQA attention whose heads do not split
    over the model axis replicates, K/V projections replicate where the
    cut would split a KV head), routed experts replicate under
    ``moe_impl="local"``; an FF axis the divisibility fallback left whole
    raises (a row-parallel product needs its cut). A vocab axis it left
    whole stays whole, as the reference's: the embedding and the logits
    then run whole on every rank."""
    from repro_torch.parallel import sharding
    mesh = ctx.mesh
    rules = sharding.serve_rules("pod" in mesh.axis_names, ep_ftp=ctx.ep_ftp)
    n = ctx.model_size

    def one(path, spec):
        ps = list(sharding.spec_to_pspec(spec, mesh, rules))
        for i, ax in enumerate(spec.axes):
            if ax == "mlp" and n > 1 and ps[i] is None:
                raise NotImplementedError(
                    f"{'/'.join(path)}: axis {ax!r} of {spec.shape} "
                    f"does not split over {n} model columns")
            elif (ax == "experts" and ctx.moe_impl == "local"
                  and "moe" in path):
                ps[i] = None
        return sharding.P(*ps)

    return sharding.whole_heads(cfg, mesh, specs,
                                sharding.map_with_path(one, specs))


def place_params(model: Model, ctx, params, seed: int, device,
                 sliced: Optional[bool] = None):
    """This rank's slices of ``model``'s prepared weights on ``ctx``'s mesh
    (:func:`serve_param_pspecs`). ``sliced``: draw each leaf's slice alone
    (``init_params(placement=)``) and prepare it in place
    (``prepare_for_serving(specs=)``), this rank's peak its shard plus one
    drawing block; else prepare the global tree (drawn from ``seed``, or
    the given ``params``), then cut it. Both give the same bytes where
    every block-quantized cut falls on 128 boundaries; by default the
    engine slices there and only for a tree it draws itself (smoke
    widths, whose cuts lie inside one block, are prepared globally)."""
    from repro_torch.parallel import sharding
    cfg, mesh = model.cfg, ctx.mesh
    specs = model.specs()
    pspecs = serve_param_pspecs(cfg, ctx, specs)
    if sliced is None:
        sliced = params is None and sharding.block_cuts_ok(specs, pspecs,
                                                           mesh)
    if sliced:
        if params is not None or not sharding.block_cuts_ok(specs, pspecs,
                                                            mesh):
            raise ValueError("a sliced draw needs no given params and "
                             "every block cut on 128 boundaries")
        local = init_params(specs, seed, device, placement=(pspecs, mesh))
        return prepare_for_serving(local, cfg, inplace=True, specs=specs)
    if params is None:
        tree = prepare_for_serving(model.init(seed), cfg, inplace=True)
    else:
        tree = prepare_for_serving(_to_device(params, device), cfg)
    return sharding.shard_tree(tree, pspecs, mesh)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class ServeEngine:
    """Fixed-slot batch engine (continuous batching-lite).

    ``stats`` holds the reference's counters, with the same values but for
    ``dispatches``: the port counts its own (a prefill, an admission, a
    prefill chunk, a graduation, a decode chunk, one each)."""

    def __init__(self, cfg: ModelConfig, params=None, slots: int = 4,
                 max_len: int = 128, seed: int = 0,
                 use_mtp: bool = False, chunk: int = 8,
                 temperature: float = 0.0, top_k: int = 0,
                 paged: bool = False, page_size: int = 8,
                 pool_pages: Optional[int] = None,
                 page_storage: str = "fp8",
                 max_pending: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 host_tier_pages: Optional[int] = None,
                 tier_config=None, tier_faults=None,
                 attn_impl: str = "",
                 decode_overlap: bool = False,
                 ctx=None, device=None):
        self.ctx = ctx
        self.meshed = ctx is not None and ctx.mesh is not None
        paged_mod.validate_storage(page_storage)
        self.cfg = cfg
        self.model = Model(cfg, device)
        self.device = self.model.device
        if attn_impl:
            # "pallas": paged decode attention (MLA or GQA) and GQA
            # bucketed prefill through the kernel registry
            self.model.impl_ctx = {"gqa_impl": attn_impl,
                                   "mla_impl": attn_impl}
        self.attn_impl = attn_impl
        # this rank's slots: a data row decodes its own (all of them
        # unmeshed, or where the data axis does not divide the slots)
        self._rows = slice(0, slots)
        self._split = False
        if self.meshed:
            dp = ctx.dp_size
            self._split = dp > 1 and slots % dp == 0
            if self._split:
                d = ctx.dp_index
                self._rows = slice(d * slots // dp, (d + 1) * slots // dp)
            self.params = self._mesh_params(params, seed)
        elif params is None:
            # the engine owns these weights: prepare them in place
            self.params = prepare_for_serving(self.model.init(seed), cfg,
                                              inplace=True)
        else:
            self.params = prepare_for_serving(
                _to_device(params, self.device), cfg)
        self.slots = slots
        self.max_len = max_len
        self.use_mtp = use_mtp and cfg.mtp is not None
        self.decode_overlap = decode_overlap
        if decode_overlap:
            # §2.3.1 dual-microbatch decode: the chunk runs the slots as
            # two anti-phase halves so each half's EP all-to-alls are in
            # flight under the other's compute
            if paged:
                raise ValueError(
                    "decode_overlap requires a dense cache: paged page "
                    "pools are shared across slots and cannot be split "
                    "into independent halves")
            if self.use_mtp:
                raise ValueError("decode_overlap is incompatible with "
                                 "use_mtp: the MTP draft ring is not "
                                 "split across halves")
            if slots % 2:
                raise ValueError(f"decode_overlap needs an even slot "
                                 f"count, got {slots}")
            local = self._rows.stop - self._rows.start
            if local % 2:
                raise ValueError(
                    f"decode_overlap needs an even slot count on each data "
                    f"row, got {local} of {slots} here")
        self.chunk = chunk
        self.temperature = temperature
        self.top_k = top_k
        self.paged = paged
        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None:
            if not paged:
                raise ValueError(
                    "prefill_chunk requires paged=True: chunked prefill "
                    "streams the prompt straight into the slot's pages")
            if prefill_chunk <= 0 or prefill_chunk % page_size:
                raise ValueError(
                    f"prefill_chunk ({prefill_chunk}) must be a positive "
                    f"multiple of page_size ({page_size}) so every chunk "
                    "writes whole pages")
            if self.use_mtp:
                raise ValueError(
                    "prefill_chunk is incompatible with use_mtp: chunked "
                    "prefill does not populate the MTP draft ring")
        if paged:
            # pool_pages defaults to the dense engine's token capacity
            self.page_size = page_size
            self.pages_per_slot = max_len // page_size
            self.pool_pages = (pool_pages if pool_pages is not None
                               else slots * self.pages_per_slot)
            self.page_storage = page_storage
            if self.meshed:
                self.cache = self._mesh_cache(self.model.init_paged_cache(
                    slots, max_len, page_size, self.pool_pages, page_storage,
                    device="meta"))
            else:
                self.cache = self.model.init_paged_cache(
                    slots, max_len, page_size, self.pool_pages, page_storage)
            self._alloc = paged_mod.PrefixPageAllocator(self.pool_pages)
            self._slot_pages: List[List[int]] = [[] for _ in range(slots)]
            self._axes = self.model.paged_aux_axes()
        else:
            self.cache = (self._mesh_cache(self.model.init_cache(
                slots, max_len, device="meta")) if self.meshed
                else self.model.init_cache(slots, max_len))
            self._axes = self.model.cache_batch_axes(slots, max_len)
        # host-memory KV page tier: the device pool becomes a cache over
        # ``host_tier_pages`` of host capacity (module docstring)
        self.tier: Optional[paged_mod.HostPageTier] = None
        if host_tier_pages is not None:
            if not paged:
                raise ValueError("host_tier_pages requires paged=True: the "
                                 "tier spills page sets, dense rings have "
                                 "none")
            self.tier = paged_mod.HostPageTier(host_tier_pages)
        elif tier_faults is not None:
            raise ValueError("tier_faults without host_tier_pages: there "
                             "is no tier transfer path to inject into")
        self.tier_cfg = (tier_config if tier_config is not None
                         else tier_mod.TierConfig())
        self.tier_faults = (tier_faults if tier_faults is not None
                            else tier_mod.NullFaultHook())
        self._xfers = tier_mod.TransferClock(self.tier_cfg)
        # rid -> suspension entry; insertion order is the resume order
        self._suspended: "collections.OrderedDict[int, Dict[str, Any]]" = \
            collections.OrderedDict()
        self._spilling_slots: Dict[int, int] = {}   # slot -> rid
        self._slot_tick0 = np.zeros((slots,), np.int64)
        self._tick = 0
        self.tstats = {"suspensions": 0, "resumes": 0, "spilled_pages": 0,
                       "fetched_pages": 0, "spill_bytes": 0,
                       "fetch_bytes": 0, "prefetch_stalls": 0,
                       "degraded": 0, "crc_failures": 0, "spill_aborts": 0,
                       "tier_full_refusals": 0, "peak_resident_pages": 0,
                       "prefix_spilled": 0, "prefix_fetched": 0}
        # host mirrors of the per-slot decode state
        self.positions = np.zeros((slots,), np.int32)   # next position
        self._tokens = np.zeros((slots,), np.int32)     # last emitted token
        self._left = np.zeros((slots,), np.int32)       # decode budget
        self._eos = np.full((slots,), -1, np.int32)
        self._seeds = np.zeros((slots,), np.int64)      # sampling identity
        self._tix = np.zeros((slots,), np.int32)        # next stream index
        self.active: List[Optional[Request]] = [None] * slots
        self.pending: Deque[Tuple[Request, Optional[Dict]]] = \
            collections.deque()
        self.max_pending = max_pending
        # scheduler state: slots mid-chunked-prefill, the prefix pages
        # retained by preempted continuations still in the queue, and each
        # slot's extras (frames or patches), which a preempted or degraded
        # request takes back to the queue and a suspended one to the tier
        self._prefilling: Dict[int, Dict[str, Any]] = {}
        self._evicted: Dict[int, List[int]] = {}
        self._slot_extras: List[Optional[Dict]] = [None] * slots
        self._hol_skips = 0
        self._seed_gen = np.random.default_rng(seed + 1)
        chunk_cache = self.cache
        if self._split and prefill_chunk is not None and "mtp_h" in self.cache:
            # the chunk of a slot that another data row holds writes its
            # ``mtp_h`` row into a scratch row one past this rank's own
            # (``_local_slot``), which only the chunk's cache shows
            own = self.cache["mtp_h"]
            rows = torch.cat([own, own[:1]])
            self.cache["mtp_h"] = rows[:-1]
            chunk_cache = dict(self.cache, mtp_h=rows)
        self._decode = DecodeChunk(
            self.model, self.params, self.cache,
            self._rows.stop - self._rows.start, chunk,
            temperature=temperature, top_k=top_k, use_mtp=self.use_mtp,
            overlap=decode_overlap, pctx=ctx if self.meshed else None,
            batch_sharded=self._split)
        if self.meshed:
            # a collective staged through host memory cannot be captured
            self._decode.graphed = False
        self._prefill = (None if prefill_chunk is None else PrefillChunk(
            self.model, self.params, chunk_cache, prefill_chunk,
            self.pages_per_slot, pctx=ctx if self.meshed else None))
        if self.meshed and self._prefill is not None:
            self._prefill.graphed = False
        self.stats = {"steps": 0, "tokens": 0, "accepted_drafts": 0,
                      "drafts": 0, "dispatches": 0, "prefills": 0,
                      "splices": 0, "first_tokens": 0, "page_admits": 0,
                      "page_releases": 0, "peak_pages_used": 0,
                      "chunk_prefills": 0, "evictions": 0}
        self._prefill_buckets: set = set()

    # -- mesh install --------------------------------------------------------
    def _mesh_params(self, params, seed: int):
        """This rank's slices of the prepared weights
        (:func:`place_params`). Another meshed engine's ``params`` (marked
        with their placement) are taken as they are when the placement is
        this engine's."""
        ctx = self.ctx
        placement = (tuple(ctx.mesh.shape.items()), ctx.mesh.rank,
                     ctx.moe_impl == "local", ctx.ep_ftp)
        if params is not None and "placement" in params:
            if params["placement"] != placement:
                raise ValueError(
                    f"params placed for {params['placement']}, this engine "
                    f"needs {placement}")
            return params
        out = place_params(self.model, ctx, params, seed, self.device)
        out["placement"] = placement
        return out

    def _mesh_cache(self, struct):
        """This rank's cache, zero-filled (``pos`` -1, the page table at
        the trash page) in the local shapes of the port's placement
        (``sharding.explicit_cache_pspecs``) of the global ``struct`` (meta
        tensors)."""
        from repro_torch.parallel import sharding
        ctx = self.ctx
        pspecs = sharding.explicit_cache_pspecs(
            struct, ctx.mesh, ctx.dp_axes, ctx.tp_axis or "model",
            paged=self.paged)
        self._cache_pspecs = pspecs

        def one(path, leaf):
            shape = sharding.local_shape(leaf.shape, sharding.at_path(
                pspecs, path), ctx.mesh)
            fill = (-1 if path[-1] == "pos" else
                    paged_mod.trash_page(self.pool_pages)
                    if path[-1] == "page_table" else 0)
            return torch.full(shape, fill, dtype=leaf.dtype,
                              device=self.device)

        return sharding.map_with_path(one, struct)

    def _local_slot(self, slot: int) -> int:
        """``slot``'s row in this rank's slot-resident leaves; a slot that
        another data row holds maps to the scratch row one past them (the
        prefill chunk's ``mtp_h`` write lands there)."""
        if not self._rows.start <= slot < self._rows.stop:
            return self._rows.stop - self._rows.start
        return slot - self._rows.start

    def _splice_slot(self, big, small, slot: int, axes) -> None:
        """:func:`_splice` into this rank's rows (a no-op for a slot of
        another data row)."""
        if self._rows.start <= slot < self._rows.stop:
            _splice(big, small, slot - self._rows.start, axes)

    def _slot_aux(self, slot: int):
        """``slot``'s slot-resident leaves (memory, MTP) as a batch-1 tree
        of device tensors, the same on every rank: under a data split only
        the owning data row holds them, so each row contributes its row at
        the slot's local index to one gather over the data group and every
        rank keeps the owner's."""
        if not self._split:
            return _slot_slice(self.cache, slot, self._axes)
        owner, local = divmod(slot, self._rows.stop - self._rows.start)
        group = self.ctx.dp_group

        def one(leaf, axis):
            mine = leaf.narrow(axis, local, 1).contiguous()
            return coll.all_gather(mine, group, dim=axis).narrow(
                axis, owner, 1)

        def walk(cache, axes):
            if isinstance(axes, dict):
                return {k: walk(cache[k], axes[k]) for k in axes}
            return one(cache, axes)

        return walk(self.cache, self._axes)

    def _tier_nbytes(self, tree, path=()) -> int:
        """Bytes of the whole tier payload of which ``tree`` (a page
        payload, or a slot's aux leaves) is this rank's cut: a leaf the
        model group cuts counts once per column. The reference's figure,
        the same on every rank, which the transfer clock and the tier's
        byte counters read."""
        if isinstance(tree, dict):
            return sum(self._tier_nbytes(v, path + (k,))
                       for k, v in tree.items())
        n = paged_mod.payload_nbytes(tree)
        if self.meshed:
            from repro_torch.parallel import sharding
            spec = sharding.at_path(self._cache_pspecs, path)
            if any(e == self.ctx.tp_axis for e in spec):
                n *= self.ctx.model_size
        return n

    def _any_rank(self, flags) -> np.ndarray:
        """``flags`` (bools) or-ed over every rank of the mesh (the model
        group, then the data group): a verdict each rank reaches from its
        own bytes alone (a CRC of its cut), which every rank must act on
        alike, or one corrupt copy would part the ranks' schedules."""
        flags = np.asarray(flags, bool)
        if not self.meshed:
            return flags
        t = torch.from_numpy(flags.astype(np.int32))
        for g in (self.ctx.tp_group, self.ctx.dp_group):
            if g is None:
                continue
            if torch.distributed.get_backend(g) != "gloo":
                t = t.to(self.device)
            t = coll.all_reduce(t, g, op="max")
        return t.cpu().numpy() > 0

    def _payload_pspecs(self, payload):
        """The model-axis cut of each leaf of a handoff payload of this
        engine (``prefill_request``'s): its cache leaf's placement with the
        data axes dropped (a batch-1 payload is replicated over the data
        rows)."""
        from repro_torch.parallel import sharding
        tp = self.ctx.tp_axis

        def model_only(path, leaf):
            spec = sharding.at_path(self._cache_pspecs, path)
            return sharding.P(*(e if e == tp else None for e in spec))

        if not self.paged:
            return sharding.map_with_path(model_only, payload)
        # a paged payload's pages and aux leaves sit where the cache's do
        return {part: sharding.map_with_path(model_only, payload[part])
                for part in ("pages", "aux")}

    def whole_payload(self, payload):
        """A handoff payload of this engine made whole, the same on every
        rank: each leaf the model group cut is gathered over it. The
        mesh-agnostic form a cross-mesh handoff carries
        (``serve/disagg.py``); unmeshed, the payload itself."""
        if not self.meshed:
            return payload
        from repro_torch.parallel import sharding
        pspecs = self._payload_pspecs(payload)
        group = self.ctx.tp_group

        def gather(path, leaf):
            for d, e in enumerate(sharding.at_path(pspecs, path)):
                if isinstance(e, sharding.Tail):
                    n = self.ctx.model_size
                    leaf = e.joined(coll.all_gather(leaf, group, dim=d)
                                    .chunk(n, dim=d), d)
                elif e is not None:
                    leaf = coll.all_gather(leaf, group, dim=d)
            return leaf

        return sharding.map_with_path(gather, payload)

    def local_payload(self, payload):
        """This rank's cut of a whole handoff payload (:meth:`whole_payload`
        of any engine of this model), as this engine's own prefill gives
        it."""
        if not self.meshed:
            return payload
        from repro_torch.parallel import sharding
        return sharding.shard_tree(payload, self._payload_pspecs(payload),
                                   self.ctx.mesh)

    def decode_alltoall_bytes(self) -> int:
        """Bytes this rank's all-to-alls move in one MoE layer of one decode
        step over every slot (``parallel/ep.alltoall_bytes``): the paper's
        §4.3 wire-byte accounting on the serving hot path, the quantity
        the reference reads off its lowered decode chunk; under
        ``decode_overlap`` both halves' bytes. 0 for unmeshed engines,
        local-MoE ones and models without experts."""
        if not (self.meshed and self.ctx.ep_enabled and self.cfg.moe):
            return 0
        from repro_torch.parallel import ep
        local = self._rows.stop - self._rows.start
        if self.decode_overlap:
            return 2 * ep.alltoall_bytes(self.cfg, self.ctx, local // 2)
        return ep.alltoall_bytes(self.cfg, self.ctx, local)

    # -- prefill ------------------------------------------------------------
    def prefill_request(self, req: Request, extras: Optional[Dict] = None):
        """Bucketed prefill of one request; returns ``(first_token,
        payload)``. Dense engines: a batch-1 cache with ``max_len`` ring
        rows (``extra_slots`` from the bucket), admitted by a splice.
        Paged engines: the quantized page payload of
        ``Model.prefill_to_pages``. Requests with delivered tokens
        (continuations) prefill prompt+delivered and sample at the advanced
        stream offset. ``extras``: the request's ``src_embeds`` (or a ready
        ``memory``) or ``patch_embeds``, batch 1, numpy or torch; the
        payload then carries the ``memory`` leaf."""
        prompt, _, offset = self._effective(req)
        L = len(prompt)
        bucket = bucket_length(L, self.max_len)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :L] = prompt
        self._prefill_buckets.add(bucket)
        self.stats["dispatches"] += 1
        self.stats["prefills"] += 1
        # paged admission quantizes the bucket-long cache into pages; dense
        # admission splices a full max_len ring
        extra = 0 if self.paged else self.max_len - bucket
        logits, payload = self.model.prefill(
            self.params, dict(extras or {}, tokens=torch.as_tensor(toks)),
            extra_slots=extra, lengths=np.asarray([L], np.int32),
            pctx=self.ctx if self.meshed else None)
        if self.paged:
            payload = self.model.prefill_to_pages(
                payload, self.page_size, self.page_storage,
                pctx=self.ctx if self.meshed else None)
        return self._sample_first(req, logits, offset), payload

    def _sample_first(self, req: Request, logits: torch.Tensor,
                      offset: int) -> int:
        """A prefill's first token: stream index ``offset`` of the request's
        sampling stream, from the logits (1, 1, V) at its last prompt
        position. The seed and the index cross in one non-blocking copy; the
        admission needs the token on the host: the one sync of a prefill."""
        ids = torch.tensor([self._request_seed(req), offset],
                           dtype=torch.int64)
        if self.device.type == "cuda":
            ids = ids.pin_memory().to(self.device, non_blocking=True)
        first = sample_logits(logits[:, -1], ids[:1], ids[1:].int(),
                              self.temperature, self.top_k)
        return int(first.cpu()[0])

    def _request_seed(self, req: Request) -> int:
        """The request's sampling seed; a seedless request gets one drawn
        from the engine's generator, kept on the request so its prefill
        and its decode draw from one stream."""
        if req.seed is None:
            req.seed = int(self._seed_gen.integers(0, 2 ** 62))
        return req.seed

    # -- admission ----------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def free_pages(self) -> int:
        """Allocatable pages in the pool (0 for dense engines)."""
        return self._alloc.free_pages() if self.paged else 0

    def _effective(self, req: Request) -> Tuple[np.ndarray, int, int]:
        """Continuation-aware view of a request: ``(prompt, max_new,
        sample_offset)``; a request with delivered tokens resumes as
        prompt+delivered with the remaining budget."""
        prompt = np.asarray(req.prompt, np.int32)
        if req.out:
            prompt = np.concatenate([prompt, np.asarray(req.out, np.int32)])
            return (prompt, req.max_new - len(req.out),
                    req.sample_offset + len(req.out))
        return prompt, req.max_new, req.sample_offset

    def pages_needed(self, req: Request) -> int:
        """Pages a request reserves at admission: prompt plus decode
        budget, rounded up (the paged cache never ring-wraps)."""
        return paged_mod.pages_for(len(req.prompt) + req.max_new,
                                   self.page_size)

    def _prefix_keys(self, prompt: np.ndarray) -> List[bytes]:
        """Index keys of a prompt's full pages (chunked-prefill engines)."""
        return paged_mod.prefix_keys(prompt, self.page_size,
                                     len(prompt) // self.page_size)

    def can_admit(self, req: Request) -> bool:
        """A slot is free and (paged engines) enough pool pages are too.
        Chunked-prefill engines probe the prefix index: a request whose
        leading pages are resident needs fresh pages only from the
        divergence point."""
        if not self.free_slots():
            return False
        if not self.paged:
            return True
        if self.prefill_chunk is None:
            return self.pages_needed(req) <= self.free_pages()
        prompt, max_new, _ = self._effective(req)
        n = paged_mod.pages_for(len(prompt) + max_new, self.page_size)
        return self._alloc.can_admit(self._prefix_keys(prompt), n,
                                     self.prefill_chunk // self.page_size)

    def _validate(self, req: Request):
        if self.paged:
            validate_request(req, self.max_len, self.page_size,
                             self.pool_pages)

    def submit(self, req: Request, extras: Optional[Dict] = None):
        """Queue a request; ``step()`` admits it when a slot and its pages
        free up. A full bounded queue raises ``AdmissionError``."""
        self._validate(req)
        if (self.max_pending is not None
                and len(self.pending) >= self.max_pending):
            raise AdmissionError(
                f"pending queue full: request {req.rid} rejected; "
                f"{len(self.pending)} queued >= max_pending "
                f"({self.max_pending})")
        self.pending.append((req, extras))

    def add_request(self, req: Request, extras: Optional[Dict] = None):
        """Prefill + admit immediately. Raises when no slot is free."""
        self._validate(req)
        free = self.free_slots()
        if not free:
            raise AdmissionError(
                f"no free slots: all {self.slots} slots are occupied; call "
                "step() until a request completes, or submit() to queue")
        first, payload = self.prefill_request(req, extras)
        self.admit_prefilled(req, first, payload, free[0])
        return first

    def admit_prefilled(self, req: Request, first: int, payload,
                        slot: int, extras: Optional[Dict] = None):
        """Admit a prefilled request into ``slot``: splice its prefill
        cache (dense), or reserve its pages, scatter its quantized prefill
        pages, install its page-table row and splice its slot-resident
        leaves, memory and MTP (paged); then the host mirrors. A request
        finished by its first token (budget 1 or an immediate EOS) writes
        and reserves nothing. ``extras`` are kept with the slot, for a
        re-admission after preemption."""
        prompt, max_new, offset = self._effective(req)
        finishes = (max_new <= 1
                    or (req.eos is not None and first == req.eos))
        if self.paged and not finishes:
            n = paged_mod.pages_for(len(prompt) + max_new, self.page_size)
            if n > self.free_pages():
                raise AdmissionError(
                    f"no free pages: request {req.rid} needs {n}, pool has "
                    f"{self.free_pages()} of {self.pool_pages}")
        req.out.append(first)
        self.stats["tokens"] += 1
        self.stats["first_tokens"] += 1
        if finishes:
            req.done = True
            return
        self.stats["dispatches"] += 1
        if self.paged:
            self._admit_pages(payload, n, slot)
        else:
            self.stats["splices"] += 1
            self._splice_slot(self.cache, payload, slot, self._axes)
        self.positions[slot] = len(prompt)
        self._tokens[slot] = first
        self._left[slot] = max_new - 1
        self._eos[slot] = -1 if req.eos is None else req.eos
        self._seeds[slot] = self._request_seed(req)
        self._tix[slot] = offset + 1     # prefill drew stream index offset
        self._slot_extras[slot] = extras
        self.active[slot] = req
        self._slot_tick0[slot] = self._tick

    def _admit_pages(self, payload, n: int, slot: int) -> None:
        """Reserve ``n`` pages for ``slot``, scatter the payload's pages
        into them (pages past the reservation land in the trash page),
        install the slot's table row and splice the aux leaves."""
        alloc = self._alloc.alloc(n)
        self._slot_pages[slot] = alloc
        trash = self.pool_pages
        row = np.full((self.pages_per_slot,), trash, np.int32)
        row[:n] = alloc
        n_p = paged_mod.payload_leaves(payload["pages"])[0].shape[1]
        ids = np.asarray([alloc[i] if i < n else trash for i in range(n_p)],
                         np.int64)
        self.stats["page_admits"] += 1
        self.stats["peak_pages_used"] = max(
            self.stats["peak_pages_used"], self.pool_pages - self.free_pages())
        self.model.admit_pages(self.cache, payload["pages"], ids, row, slot)
        if payload["aux"]:
            self._splice_slot({k: self.cache[k] for k in payload["aux"]},
                              payload["aux"], slot, self._axes)

    # -- scheduler ----------------------------------------------------------
    def _admit_now(self, req: Request, extras: Optional[Dict]):
        slot = self.free_slots()[0]
        if self.prefill_chunk is not None:
            self._admit_chunked(req, extras, slot)
        else:
            first, payload = self.prefill_request(req, extras)
            self.admit_prefilled(req, first, payload, slot, extras=extras)

    def _admit_chunked(self, req: Request, extras: Optional[Dict],
                       slot: int):
        """Reserve pages (claiming any indexed prefix run) and start the
        slot's chunked prefill; the prompt streams through
        ``_run_prefill_chunk`` one chunk a tick. Pages claimed from the
        index are shared and never written again: the chunks that would
        have computed them are skipped, and fresh pages take over from the
        divergence point (the copy-on-write fork)."""
        if extras:
            raise ValueError(
                "prefill_chunk admission does not support extras "
                "(encoder/vision payloads need whole-prompt prefill)")
        prompt, max_new, offset = self._effective(req)
        L, p, C = len(prompt), self.page_size, self.prefill_chunk
        n = paged_mod.pages_for(L + max_new, p)
        keys = self._prefix_keys(prompt)
        held = self._evicted.pop(req.rid, None)
        if held is not None:
            # a resuming continuation re-claims its retained prefix pages
            # through the index (they stay indexed)
            self._alloc.release(held)
        try:
            hits, fresh = self._alloc.admit(keys, n, C // p)
        except RuntimeError as e:
            raise AdmissionError(
                f"no free pages: request {req.rid} needs up to {n}, pool "
                f"has {self.free_pages()} of {self.pool_pages}") from e
        pages = hits + fresh
        self._slot_pages[slot] = pages
        self._slot_extras[slot] = extras
        row = np.full((self.pages_per_slot,), self.pool_pages, np.int32)
        row[:n] = pages
        self.stats["page_admits"] += 1
        self.stats["peak_pages_used"] = max(
            self.stats["peak_pages_used"], self.pool_pages - self.free_pages())
        # the row travels as a chunk operand; the cache's row stays at the
        # trash page until graduation. Shared pages cover whole chunks, so
        # prefill resumes at the divergence chunk, but never past the chunk
        # of the last prompt token, whose logits give the first token (a
        # re-run of that chunk writes the same bytes into any shared page
        # it overlaps)
        skip = min(len(hits) * p, (L - 1) // C * C)
        self._prefilling[slot] = dict(req=req, keys=keys, next=skip,
                                      prompt=prompt, max_new=max_new,
                                      offset=offset, row=row)
        self.active[slot] = req
        self._slot_tick0[slot] = self._tick
        if self.tier is not None:
            self._probe_tier_prefix(slot, hits, fresh, keys, L, skip)

    def _probe_tier_prefix(self, slot: int, hits: List[int],
                           fresh: List[int], keys: List[bytes], L: int,
                           skip: int):
        """Extend a chunked admission's shared-prefix run with host-tier
        prefix pages: pages past the device hit run that the tier holds
        are fetched into the slot's fresh pages instead of recomputed. The
        prefill cursor advances only when the fetch lands CRC-clean
        (``_finish_prefix_fetch``); until then the slot runs no chunk, so
        no chunk reads a page before its bytes are installed."""
        p, C = self.page_size, self.prefill_chunk
        ppc = C // p
        h = len(hits)
        if skip != h * p:
            return   # device hits already reach the final-chunk bound
        bound_pages = ((L - 1) // C * C) // p
        run = min(self.tier.prefix_run(keys[h:], ppc),
                  bound_pages - h) // ppc * ppc
        if run <= 0:
            return
        tkeys = keys[h:h + run]
        stored = self.tier.take_prefix(tkeys)
        ps = self._prefilling[slot]
        ps["tier_xfer"] = True
        self._xfers.submit(
            tier_mod.PREFIX_FETCH, ps["req"].rid, None,
            sum(self._tier_nbytes(pg) for pg, _ in stored),
            slow=self.tier_faults.slow(), slot=slot, req=ps["req"],
            keys=tkeys, stored=stored, pages=fresh[:run],
            end=(h + run) * p)

    def _run_prefill_chunk(self, slot: int):
        """Advance one prefilling slot by one chunk (one replay of the
        chunk graph on the card, ``serve/graph.PrefillChunk``); the last
        chunk samples the first token and graduates the slot to decoding.
        A chunk's operands cross in one non-blocking copy, so only the last
        chunk waits for the card (for its first token)."""
        ps = self._prefilling[slot]
        req, prompt = ps["req"], ps["prompt"]
        C, p, L = self.prefill_chunk, self.page_size, len(prompt)
        start = ps["next"]
        toks = np.zeros((C,), np.int32)
        toks[:min(L, start + C) - start] = prompt[start:start + C]
        self.stats["dispatches"] += 1
        self.stats["chunk_prefills"] += 1
        logits = self._prefill(toks, start, L, self._local_slot(slot),
                               ps["row"])
        # index the chunk's full prompt pages: under the fixed chunk grid
        # their bytes are a function of the token prefix alone, and the
        # write is queued, so a sharer's later reads follow it on the stream
        for j in range(start // p, min((start + C) // p, len(ps["keys"]))):
            self._alloc.register(ps["keys"][j], self._slot_pages[slot][j])
        ps["next"] = start + C
        if ps["next"] < L:
            return
        del self._prefilling[slot]
        # graduation: the slot decodes from the next chunk on, so its row
        # replaces the trash row in the table the decode graph reads (a
        # device copy from the chunk's input, ordered after the chunk and
        # before the next decode replay)
        self.stats["dispatches"] += 1
        self.cache["page_table"][slot].copy_(self._prefill.row)
        first = self._sample_first(req, logits, ps["offset"])
        req.out.append(first)
        self.stats["tokens"] += 1
        self.stats["first_tokens"] += 1
        if ps["max_new"] <= 1 or (req.eos is not None and first == req.eos):
            # no decode step: the whole reservation goes back to the pool
            req.done = True
            self._release_slot(slot)
            return
        self.positions[slot] = L
        self._tokens[slot] = first
        self._left[slot] = ps["max_new"] - 1
        self._eos[slot] = -1 if req.eos is None else req.eos
        self._seeds[slot] = self._request_seed(req)
        self._tix[slot] = ps["offset"] + 1
        self._slot_tick0[slot] = self._tick   # quantum clock: decode start

    def _pick_admission(self) -> Optional[int]:
        """Pending entry to admit next: highest priority first, FIFO within
        a class, with page-aware skip-ahead bounded by the starvation
        guard."""
        order = sorted(range(len(self.pending)),
                       key=lambda i: (-self.pending[i][0].priority, i))
        for rank, i in enumerate(order):
            if self.can_admit(self.pending[i][0]):
                if rank == 0:
                    self._hol_skips = 0
                elif self._hol_skips >= STARVATION_LIMIT:
                    return None   # head starved: next pages are its
                else:
                    self._hol_skips += 1
                return i
        return None

    def _try_evict(self, inc: int) -> bool:
        """Free capacity for an incoming priority-``inc`` request: evict the
        lowest-priority decoding resident of strictly lower priority, or,
        when none qualifies, abort the fetch of a strictly-lower-priority
        suspended entry (its host copy survives; the fetch restarts later),
        or reclaim the retained prefix pages of a queued continuation of
        strictly lower priority (it will re-prefill; its stream is the same
        either way). Tiered engines prefer *spilling* the victim to
        evicting it — its KV moves to the host instead of being recomputed
        — and then return False: the capacity arrives when the spill lands,
        and the caller must not preempt again for the same arrival this
        tick."""
        victims = [(r.priority, s) for s, r in enumerate(self.active)
                   if r is not None and s not in self._prefilling
                   and s not in self._spilling_slots
                   and r.priority < inc]
        if victims:
            slot = min(victims)[1]
            if self.tier is not None and self._begin_suspend(slot):
                return False
            self._evict_slot(slot)
            return True
        if self.tier is not None:
            fetching = [(e["req"].priority, rid)
                        for rid, e in self._suspended.items()
                        if e["state"] == "fetching"
                        and e["req"].priority < inc]
            if fetching:
                rid = min(fetching)[1]
                e = self._suspended[rid]
                self._xfers.cancel(lambda t: t.rid == rid
                                   and t.kind == tier_mod.FETCH)
                self.tier.abort_fetch(e["eid"])
                self._alloc.release(e["fetch_pages"])
                e["fetch_pages"], e["tier_entry"] = None, None
                e["state"] = "host"
                return True
        held = [(req.priority, i) for i, (req, _) in enumerate(self.pending)
                if req.priority < inc and req.rid in self._evicted]
        if held:
            rid = self.pending[min(held)[1]][0].rid
            self._alloc.release(self._evicted.pop(rid))
            return True
        return False

    def _evict_slot(self, slot: int):
        """Preempt a resident: free its slot and pages and put it back at
        the head of the queue as a continuation (prompt + delivered,
        remaining budget, advanced stream index). Under chunked prefill its
        full written pages are indexed first and their references kept in
        ``_evicted``, so its resume re-claims the KV it already computed."""
        req = self.active[slot]
        extras = self._slot_extras[slot]
        held: List[int] = []
        if self.paged and self.prefill_chunk is not None:
            pages = self._slot_pages[slot]
            prompt, _, _ = self._effective(req)
            # the KV written so far stops at positions[slot]: the last
            # emitted token's KV lands only when it is fed
            n_keys = min(int(self.positions[slot]) // self.page_size,
                         len(pages))
            keys = paged_mod.prefix_keys(prompt, self.page_size, n_keys)
            for j, key in enumerate(keys):
                self._alloc.register(key, pages[j])
                if self._alloc.lookup(key) != pages[j]:
                    break   # another slot owns this prefix from here on
                held.append(pages[j])
            if held:
                self._evicted[req.rid] = held
                self._slot_pages[slot] = pages[len(held):]
        self.stats["evictions"] += 1
        self._release_slot(slot)
        self.pending.appendleft((req, extras))

    def _admit_pending(self) -> int:
        admitted = 0
        while self.pending:
            i = self._pick_admission()
            if i is not None:
                req, extras = self.pending[i]
                del self.pending[i]
                self._admit_now(req, extras)
                admitted += 1
                continue
            # everything admissible is in: preempt for the highest-priority
            # blocked entry, and keep what that frees for it alone (letting
            # a lower class, often the victim itself, take it would thrash)
            head_i = max(range(len(self.pending)),
                         key=lambda j: (self.pending[j][0].priority, -j))
            head = self.pending[head_i][0]
            if not self._try_evict(head.priority):
                break
            while not self.can_admit(head) and self._try_evict(head.priority):
                pass
            if not self.can_admit(head):
                break
            # eviction re-queues at the left: find the head by identity
            head_i = next(j for j, (q, _) in enumerate(self.pending)
                          if q is head)
            req, extras = self.pending[head_i]
            del self.pending[head_i]
            self._admit_now(req, extras)
            admitted += 1
        return admitted

    # -- host page tier (paper §4.5 memory hierarchy) ------------------------
    def _begin_suspend(self, slot: int) -> bool:
        """Start spilling ``slot``'s whole page set to the host tier.

        The gather and the staged copy happen now (the slot's masked decode
        lane would otherwise keep writing its aux leaves, and a reused slot
        would overwrite them), the table row goes to the trash page at once
        so no later chunk writes into the captured pages, and the transfer
        clock decides when the host copy counts as durable: the slot and
        its device pages stay held until the spill lands, so a failed spill
        resumes in place with no work lost. Returns False when the tier
        cannot take the pages (the caller evicts instead)."""
        req = self.active[slot]
        pages = self._slot_pages[slot]
        n = len(pages)
        if n == 0:
            return False
        if self.tier_faults.full():
            self.tstats["tier_full_refusals"] += 1
            return False
        eid = self.tier.reserve(n)
        if eid is None:
            self.tstats["tier_full_refusals"] += 1
            return False
        self.stats["dispatches"] += 1
        host = tier_mod.staged_get(dict(
            pages=self.model.gather_pages(self.cache, pages),
            aux=self._slot_aux(slot)))
        payload, aux = host["pages"], host["aux"]
        crcs = paged_mod.payload_page_crcs(payload, n)
        aux_crc = paged_mod.payload_crc(aux)
        nbytes = self._tier_nbytes(payload) + self._tier_nbytes(aux)
        # trash the row now: the captured bytes must stay as they are while
        # the transfer is in flight (the lane is masked out of decode, but
        # a masked lane still writes through its row)
        self.stats["dispatches"] += 1
        self.model.release_slot_pages(self.cache, slot)
        mirrors = dict(pos=int(self.positions[slot]),
                       tok=int(self._tokens[slot]),
                       left=int(self._left[slot]),
                       eos=int(self._eos[slot]),
                       seed=int(self._seeds[slot]),
                       tix=int(self._tix[slot]))
        self._xfers.submit(tier_mod.SPILL, req.rid, eid, nbytes,
                           slow=self.tier_faults.slow())
        self._suspended[req.rid] = dict(
            req=req, extras=self._slot_extras[slot], state="spilling",
            eid=eid, n=n, slot=slot, pages=None,
            fetch_pages=None, tier_entry=None, payload=payload, aux=aux,
            crcs=crcs, aux_crc=aux_crc, mirrors=mirrors)
        self._spilling_slots[slot] = req.rid
        self.tstats["suspensions"] += 1
        return True

    def _finish_spill(self, t: tier_mod.TierTransfer):
        """A spill landed: the host copy is durable, so the device side —
        slot and pages — frees (the row was trashed at suspend)."""
        e = self._suspended.get(t.rid)
        if e is None or e["state"] != "spilling":
            return   # cancelled while in flight
        self.tier.commit(e["eid"], e["payload"], e["aux"], e["crcs"],
                         e["aux_crc"])
        slot = e.pop("slot")
        del self._spilling_slots[slot]
        self._alloc.release(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self.stats["page_releases"] += 1
        self.active[slot] = None
        self._slot_extras[slot] = None
        e["state"] = "host"
        e["payload"] = None   # the tier owns the bytes now
        self.tstats["spilled_pages"] += e["n"]
        self.tstats["spill_bytes"] += t.nbytes

    def _fail_spill(self, t: tier_mod.TierTransfer):
        """A spill failed for good: resume in place. The device pages were
        never released, so installing the row and the aux leaves again
        loses nothing — the degradation ladder's cheapest rung."""
        e = self._suspended.pop(t.rid, None)
        if e is None:
            return
        self.tier.free(e["eid"])
        slot = e["slot"]
        del self._spilling_slots[slot]
        self.tstats["spill_aborts"] += 1
        self._install_slot(slot, self._slot_pages[slot], e["aux"])
        self._restore_mirrors(slot, e["mirrors"])
        self._slot_tick0[slot] = self._tick

    def _install_slot(self, slot: int, pages: List[int], aux) -> None:
        """Point ``slot``'s table row at ``pages`` and write its aux leaves
        back, in place: the row and the aux cross in one staged copy, then
        two device copies into the leaves the graphs read."""
        row = np.full((self.pages_per_slot,), self.pool_pages, np.int32)
        row[:len(pages)] = pages
        self.stats["dispatches"] += 1
        dev = tier_mod.staged_put(dict(row=torch.from_numpy(row), aux=aux),
                                  self.device)
        self.cache["page_table"][slot].copy_(dev["row"])
        if aux:
            self._splice_slot({k: self.cache[k] for k in aux}, dev["aux"],
                              slot, self._axes)

    def _restore_mirrors(self, slot: int, m: Dict[str, Any]):
        self.positions[slot] = m["pos"]
        self._tokens[slot] = m["tok"]
        self._left[slot] = m["left"]
        self._eos[slot] = m["eos"]
        self._seeds[slot] = m["seed"]
        self._tix[slot] = m["tix"]

    def _start_fetches(self):
        """Prefetch ahead: start host->device transfers for suspended
        entries, oldest suspension first, with whatever pool pages
        admission left this tick. A page-blocked entry blocks the ones
        behind it, and once the pending head's starvation guard has
        tripped the freed pages are its alone, so no fetch starts."""
        if self.tier is None:
            return
        if self.pending and self._hol_skips >= STARVATION_LIMIT:
            return
        for rid, e in self._suspended.items():
            if e["state"] != "host":
                continue
            n = e["n"]
            if n > self.free_pages():
                break
            e["fetch_pages"] = self._alloc.alloc(n)
            ent = self.tier.begin_fetch(e["eid"])
            e["tier_entry"] = ent
            e["state"] = "fetching"
            nbytes = (self._tier_nbytes(ent.payload)
                      + self._tier_nbytes(ent.aux))
            self._xfers.submit(tier_mod.FETCH, rid, e["eid"], nbytes,
                               slow=self.tier_faults.slow())

    def _finish_fetch(self, t: tier_mod.TierTransfer):
        """A fetch landed: CRC-check the host bytes, install them into the
        reserved device pages (a staged copy and an in-place scatter,
        queued before the next replay) and mark the entry ready to resume
        when a slot frees. A CRC mismatch walks the degradation ladder."""
        e = self._suspended.get(t.rid)
        if e is None or e["state"] != "fetching":
            return
        ent, n = e["tier_entry"], e["n"]
        if self._any_rank([
                paged_mod.payload_page_crcs(ent.payload, n) != ent.crcs
                or paged_mod.payload_crc(ent.aux) != ent.aux_crc])[0]:
            self.tstats["crc_failures"] += 1
            self._degrade(t.rid)
            return
        pages = e["fetch_pages"]
        self.stats["dispatches"] += 1
        self.model.install_pages(
            self.cache, tier_mod.staged_put(ent.payload, self.device), pages)
        e["aux"] = ent.aux
        e["pages"], e["fetch_pages"] = pages, None
        e["tier_entry"] = None
        e["state"] = "ready"
        self.tier.free(e["eid"])
        self.tstats["fetched_pages"] += n
        self.tstats["fetch_bytes"] += t.nbytes

    def _degrade(self, rid: int):
        """Unrecoverable fetch (retries exhausted, timeout or CRC): drop
        the tiered copy and re-queue the request as a continuation, which
        re-prefills prompt + delivered at the advanced stream index."""
        e = self._suspended.pop(rid, None)
        if e is None:
            return
        if e["fetch_pages"]:
            self._alloc.release(e["fetch_pages"])
        self.tier.free(e["eid"])
        self.tstats["degraded"] += 1
        self.pending.appendleft((e["req"], e["extras"]))

    def _resume_ready(self) -> int:
        """Re-admit fetched entries (suspension order) into free slots: the
        row and aux installed, the host mirrors restored — no prefill, no
        recompute. Runs after admission, so new requests get the first
        claim on slots."""
        resumed = 0
        for rid in list(self._suspended):
            e = self._suspended[rid]
            if e["state"] != "ready":
                continue
            free = self.free_slots()
            if not free:
                break
            slot = free[0]
            self._install_slot(slot, e["pages"], e["aux"])
            del self._suspended[rid]
            self._slot_pages[slot] = e["pages"]
            self._slot_extras[slot] = e["extras"]
            self.active[slot] = e["req"]
            self._restore_mirrors(slot, e["mirrors"])
            self._slot_tick0[slot] = self._tick
            self.tstats["resumes"] += 1
            resumed += 1
        return resumed

    def _rotate(self):
        """Time-slice rotation: with waiters (queued requests or suspended
        entries), suspend the longest-resident decoding slot whose quantum
        expired, so an oversubscribed workload round-robins through the
        device pool instead of re-prefilling or starving the queue."""
        waiters = [req.priority for req, _ in self.pending]
        waiters += [e["req"].priority for e in self._suspended.values()
                    if e["state"] != "spilling"]
        if not waiters:
            return
        cap = max(waiters)
        decoding = [s for s in range(self.slots)
                    if self.active[s] is not None
                    and s not in self._prefilling
                    and s not in self._spilling_slots]
        ready = any(e["state"] == "ready"
                    for e in self._suspended.values())
        if len(decoding) <= 1 and not ready:
            return   # never idle the whole pool waiting on the PCIe link
        expired = [(self._slot_tick0[s], s) for s in decoding
                   if self._tick - self._slot_tick0[s] >= self.tier_cfg.quantum
                   and self.active[s].priority <= cap]
        if expired:
            self._begin_suspend(min(expired)[1])

    def _harvest_prefix(self):
        """Warm-LRU prefix spill: when the plain free pool runs dry and
        refcount-0 prefix pages sit in the device cache, move the coldest
        batch to the tier's prefix store; they come back through
        admission's tier probe instead of being recomputed. The pages stay
        pinned until the host copy is durable; a failed spill indexes them
        again (nothing is lost either way: they are cache copies)."""
        if self.prefill_chunk is None or self.tier_faults.full():
            return
        if self._alloc.plain_free() > 0 or self._alloc.cached_free() == 0:
            return
        k = min(self.tier_cfg.harvest_batch, self.pages_per_slot,
                self.tier.free_pages())
        harvested = self._alloc.harvest(k)
        if not harvested:
            return
        self.stats["dispatches"] += 1
        payload = tier_mod.staged_get(self.model.gather_pages(
            self.cache, [pid for pid, _ in harvested]))
        self._xfers.submit(tier_mod.PREFIX_SPILL, None, None,
                           self._tier_nbytes(payload),
                           slow=self.tier_faults.slow(),
                           harvest=harvested, payload=payload)

    def _finish_prefix_spill(self, t: tier_mod.TierTransfer):
        for j, (pid, key) in enumerate(t.meta["harvest"]):
            pg = tier_mod.slice_page(t.meta["payload"], j)
            self.tier.put_prefix(key, pg, paged_mod.payload_crc(pg))
        self._alloc.release([pid for pid, _ in t.meta["harvest"]])
        self.tstats["prefix_spilled"] += len(t.meta["harvest"])
        self.tstats["spill_bytes"] += t.nbytes

    def _fail_prefix_spill(self, t: tier_mod.TierTransfer):
        # the device copy never left: index the pages again (the release
        # parks them back in the warm cache) and count the abort
        for pid, key in t.meta["harvest"]:
            self._alloc.register(key, pid)
        self._alloc.release([pid for pid, _ in t.meta["harvest"]])
        self.tstats["spill_aborts"] += 1

    def _finish_prefix_fetch(self, t: tier_mod.TierTransfer):
        """Tier prefix pages arrived for a prefilling slot: check their
        CRCs, install them into the slot's reserved fresh pages, index
        them, and move the prefill cursor past the chunks they cover. A CRC
        mismatch drops the poisoned tier entries and leaves the cursor
        alone: the chunks recompute into the same pages, bit for bit."""
        m = t.meta
        slot = m["slot"]
        ps = self._prefilling.get(slot)
        if ps is None or ps.get("req") is not m["req"]:
            return   # slot cancelled/recycled while the fetch flew
        ps["tier_xfer"] = False
        bad = np.flatnonzero(self._any_rank(
            [paged_mod.payload_crc(pg) != crc for pg, crc in m["stored"]]))
        if bad.size:
            self.tstats["crc_failures"] += 1
            for j in bad:
                self.tier.drop_prefix(m["keys"][j])
            return
        pages = m["pages"]
        self.stats["dispatches"] += 1
        self.model.install_pages(
            self.cache, tier_mod.staged_put(tier_mod.concat_pages(
                [pg for pg, _ in m["stored"]]), self.device), pages)
        for j, key in enumerate(m["keys"]):
            self._alloc.register(key, pages[j])
        ps["next"] = m["end"]
        self.tstats["prefix_fetched"] += len(pages)
        self.tstats["fetch_bytes"] += t.nbytes

    def _fail_prefix_fetch(self, t: tier_mod.TierTransfer):
        ps = self._prefilling.get(t.meta["slot"])
        if ps is not None and ps.get("req") is t.meta["req"]:
            ps["tier_xfer"] = False   # cursor untouched: chunks recompute

    def _advance_transfers(self):
        done, failed = self._xfers.advance(self.tier_faults)
        for t in done:
            if t.kind == tier_mod.SPILL:
                self._finish_spill(t)
            elif t.kind == tier_mod.FETCH:
                self._finish_fetch(t)
            elif t.kind == tier_mod.PREFIX_SPILL:
                self._finish_prefix_spill(t)
            elif t.kind == tier_mod.PREFIX_FETCH:
                self._finish_prefix_fetch(t)
        for t in failed:
            if t.kind == tier_mod.SPILL:
                self._fail_spill(t)
            elif t.kind == tier_mod.FETCH:
                self._degrade(t.rid)
            elif t.kind == tier_mod.PREFIX_SPILL:
                self._fail_prefix_spill(t)
            elif t.kind == tier_mod.PREFIX_FETCH:
                self._fail_prefix_fetch(t)

    # -- decode -------------------------------------------------------------
    def _decoding(self) -> np.ndarray:
        """Slots whose lane the decode chunk runs: occupied, not
        mid-chunked-prefill and not mid-spill (a spilling slot's row is at
        the trash page and its pages are being copied out)."""
        return np.array([r is not None and i not in self._prefilling
                         and i not in self._spilling_slots
                         for i, r in enumerate(self.active)])

    def _host_state(self) -> Dict[str, np.ndarray]:
        """The decode state of every slot from the host mirrors (the
        chunk's one host-to-device copy)."""
        return dict(tokens=self._tokens, positions=self.positions,
                    active=self._decoding(), left=self._left, eos=self._eos,
                    tix=self._tix, seeds=self._seeds)

    def _run_decode(self, host: Dict[str, np.ndarray]):
        """One decode chunk over this rank's slots; on a data-split mesh
        the results of every data row are gathered into whole-slot arrays
        (one gather of one packed int64 block), so every rank's mirrors
        update alike. The MTP counters come back summed over the rows."""
        if not self._split:
            return self._decode(host)
        r = self._rows
        toks, emitted, st = self._decode({k: v[r] for k, v in host.items()})
        k = toks.shape[1]
        names = list(st)
        block = np.concatenate([toks, emitted, np.stack(
            [st[n] for n in names], axis=1)], axis=1).astype(np.int64)
        t = torch.from_numpy(block)
        g = self.ctx.dp_group
        if torch.distributed.get_backend(g) != "gloo":
            t = t.to(self.device)
        every = coll.all_gather(t, g).cpu().numpy()
        per = r.stop - r.start
        out = {n: every[:, 2 * k + i].astype(np.int32)
               for i, n in enumerate(names)}
        for n in ("drafts", "accepted"):
            out[n] = np.full(self.slots, out[n][::per].sum(), np.int32)
        return (every[:, :k].astype(np.int32),
                every[:, k:2 * k].astype(bool), out)

    def step(self):
        """One scheduler tick: admit from the pending queue (priority order,
        page-aware, preempting a lower-priority resident for a blocked
        arrival), advance the lowest prefilling slot by one chunk, then one
        fused ``chunk``-step decode over the decoding slots (one graph
        replay on the card) and one read-back of the emitted tokens, the
        slot state and the chunk's draft counters.

        Tiered engines first advance the transfer clock (a landed spill
        frees its slot and pages, a landed fetch readies a resume), admit,
        resume fetched entries into free slots, rotate a quantum-expired
        resident out for waiters, start prefetches with the pages left and
        harvest cold prefix pages; spilling slots stay out of the decode
        chunk. Fetches start once more after the decode, so pages freed by
        this tick's completions are in flight by the next."""
        if self.tier is not None:
            self._tick += 1
            self.tier_faults.on_tick()
            self._advance_transfers()
            admitted = self._admit_pending()
            resumed = self._resume_ready()
            if (not admitted and not resumed and self.free_slots()
                    and any(e["state"] in ("host", "fetching")
                            for e in self._suspended.values())):
                # a slot sat idle this tick because tiered KV was not back
                # yet: the prefetch schedule exists to keep this at 0
                self.tstats["prefetch_stalls"] += 1
            self._rotate()
            self._start_fetches()
            self._harvest_prefix()
            live = sum(len(p) for p in self._slot_pages) + sum(
                e["n"] for e in self._suspended.values()
                if e["state"] != "spilling")
            self.tstats["peak_resident_pages"] = max(
                self.tstats["peak_resident_pages"], live)
        else:
            self._admit_pending()
        # one chunk of one long-prompt admission a tick, so resident streams
        # keep decoding between chunks; a slot whose prefix pages are on
        # their way from the tier waits for them
        runnable = [s for s, ps in self._prefilling.items()
                    if not ps.get("tier_xfer")]
        if runnable:
            self._run_prefill_chunk(min(runnable))
        if not self._decoding().any():
            return
        self.stats["dispatches"] += 1
        toks, emitted, st = self._run_decode(self._host_state())
        self.stats["steps"] += int(emitted.any(axis=0).sum())
        self.stats["drafts"] += int(st["drafts"][0])
        self.stats["accepted_drafts"] += int(st["accepted"][0])
        # prefilling and spilling slots keep their host mirrors: their
        # masked lanes carry stale state (a spilling slot's own mirrors
        # ride its tier entry)
        keep = np.array([i in self._prefilling or i in self._spilling_slots
                         for i in range(self.slots)])
        self._tokens = np.where(keep, self._tokens, st["tokens"])
        self.positions = np.where(keep, self.positions, st["positions"])
        self._left = np.where(keep, self._left, st["left"])
        self._tix = np.where(keep, self._tix, st["tix"])
        for i, r in enumerate(self.active):
            if r is None or keep[i]:
                continue
            new = toks[i, emitted[i]]
            r.out.extend(int(t) for t in new)
            self.stats["tokens"] += int(new.size)
            if not st["active"][i]:
                r.done = True
                self._release_slot(i)
        if self.tier is not None:
            # pages freed by this tick's completions feed the prefetch
            # schedule at once: the fetch lands on the next tick's clock
            # advance, before the freed slot is scheduled again
            self._start_fetches()

    def _release_slot(self, slot: int):
        """Free ``slot``: clear occupancy and (paged) return its whole page
        reservation to the pool and point its table row at the trash
        page."""
        self.active[slot] = None
        self._slot_extras[slot] = None
        if self.paged and self._slot_pages[slot]:
            self._alloc.release(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self.stats["page_releases"] += 1
            self.model.release_slot_pages(self.cache, slot)

    def cancel(self, rid: int) -> bool:
        """Abort a request by id: drop it from the pending queue (an
        evicted continuation also releases the prefix pages it kept), free
        its slot, mid-chunked-prefill or decoding alike (its pages go back
        to the pool and its lane is masked out of the next decode chunk),
        or, on tiered engines, unwind whichever tier state it is in
        (spilling, host, fetching, ready): device and host pages both free
        and its in-flight transfers leave the clock. The request is left as
        it is (``done`` stays False, ``out`` keeps what was delivered).
        Returns False for an unknown id."""
        for i, (req, _) in enumerate(self.pending):
            if req.rid == rid:
                del self.pending[i]
                held = self._evicted.pop(rid, None)
                if held:
                    self._alloc.release(held)
                return True
        e = self._suspended.pop(rid, None)
        if e is not None:
            self._xfers.cancel(lambda t: t.rid == rid)
            st = e["state"]
            if st == "spilling":
                # slot and device pages still held; row already trashed
                slot = e["slot"]
                del self._spilling_slots[slot]
                self.tier.free(e["eid"])
                self._release_slot(slot)
            elif st == "host":
                self.tier.free(e["eid"])
            elif st == "fetching":
                self.tier.free(e["eid"])
                if e["fetch_pages"]:
                    self._alloc.release(e["fetch_pages"])
            else:   # ready: tier entry already freed, device pages held
                self._alloc.release(e["pages"])
            return True
        for slot, req in enumerate(self.active):
            if req is not None and req.rid == rid:
                self._prefilling.pop(slot, None)
                if self.tier is not None:
                    self._xfers.cancel(lambda t: t.rid == rid)
                self._release_slot(slot)
                return True
        return False

    # -- introspection --------------------------------------------------------
    @property
    def compiled_prefill_buckets(self) -> List[int]:
        """Sorted bucket lengths this engine has prefilled: the reference's
        property, whose buckets are those with a compiled prefill program.
        The port runs each bucket's prefill eagerly, at that one shape."""
        return sorted(self._prefill_buckets)

    @property
    def trace_counts(self) -> Dict[str, int]:
        """The reference's introspection, with the keys the port has, each
        counting its graph's CUDA captures: ``"decode"``, the decode chunk
        (1 on the card once a second decode chunk has run, whatever the
        ticks after), and ``"chunk"``, the prefill chunk (1 on a chunked
        engine once a second prefill chunk has run; every chunk of every
        prompt shares one static ``(1, prefill_chunk)`` shape). Both stay 0
        on the CPU, where the chunks run eagerly and nothing is captured,
        and ``"chunk"`` stays 0 on an engine without ``prefill_chunk``. The
        reference's other keys count jit traces the port has no counterpart
        of: its bucketed prefill, admission, release and table installs,
        and the tier's gather, scatter and resume, all run eagerly here, so
        tier spills and fetches leave both counts as they are."""
        return {"decode": self._decode.captures,
                "chunk": 0 if self._prefill is None
                else self._prefill.captures}

    def pool_stats(self) -> Dict[str, Any]:
        """Page-pool occupancy (zeros for dense engines); tiered engines add
        the host side."""
        if not self.paged:
            return dict(pages_total=0, pages_free=0, pages_used=0,
                        occupancy=0.0)
        free = self.free_pages()
        used = self.pool_pages - free
        out = dict(pages_total=self.pool_pages, pages_free=free,
                   pages_used=used,
                   occupancy=used / self.pool_pages if self.pool_pages
                   else 0.0)
        if self.tier is not None:
            out.update(host_pages_total=self.tier.capacity_pages,
                       host_pages_free=self.tier.free_pages(),
                       host_occupancy=self.tier.occupancy())
        return out

    def tier_stats(self) -> Dict[str, Any]:
        """Host-tier residency and transfer counters (``tstats`` plus the
        live tier and clock occupancy); the zeroed counters on an engine
        without a tier."""
        out = dict(self.tstats)
        if self.tier is None:
            out.update(host_pages_total=0, host_pages_used=0,
                       host_pages_free=0, host_occupancy=0.0,
                       host_prefix_pages=0, suspended=0,
                       transfers_inflight=0, retries=0, timeouts=0)
            return out
        out.update(host_pages_total=self.tier.capacity_pages,
                   host_pages_used=self.tier.used_pages(),
                   host_pages_free=self.tier.free_pages(),
                   host_occupancy=self.tier.occupancy(),
                   host_prefix_pages=self.tier.prefix_pages(),
                   suspended=len(self._suspended),
                   transfers_inflight=len(self._xfers.inflight),
                   retries=self._xfers.retries,
                   timeouts=self._xfers.timeouts)
        return out

    def prefix_stats(self) -> Dict[str, Any]:
        """Prefix-index effectiveness (zeros for dense engines): admission
        lookups of full prompt pages, the hits among them, and the pages
        that back index entries now; tiered engines add the tier's prefix
        store."""
        if not self.paged:
            return dict(lookups=0, hits=0, hit_rate=0.0, indexed_pages=0)
        lk = self._alloc.prefix_lookups
        out = dict(lookups=lk, hits=self._alloc.prefix_hits,
                   hit_rate=self._alloc.prefix_hits / lk if lk else 0.0,
                   indexed_pages=self._alloc.indexed_pages())
        if self.tier is not None:
            out.update(tier_prefix_pages=self.tier.prefix_pages(),
                       tier_prefix_evictions=self.tier.prefix_evictions,
                       tier_prefix_fetched=self.tstats["prefix_fetched"])
        return out

    def cache_bytes_per_token(self) -> float:
        """Attention-cache bytes per token of context capacity (the paper's
        Table 1 lever). Dense: the rings (values + ``pos``) over ``slots *
        max_len`` tokens. Paged: pool pages (values + scales, trash page
        excluded) over ``pool_pages * page_size`` tokens, plus the page
        table."""
        leaves = paged_mod.payload_leaves(
            {seg.name: self.cache[seg.name] for seg in self.model.segments})
        total = sum(t.numel() * t.element_size() for t in leaves)
        if not self.paged:
            return total / (self.slots * self.max_len)
        per_page = total / (self.pool_pages + 1)
        table = self.cache["page_table"]
        return per_page / self.page_size + (
            table.numel() * table.element_size()
            / (self.slots * self.max_len))

    def has_work(self) -> bool:
        """Whether another ``step()`` can make progress: queued or resident
        requests, entries parked in the host tier, or transfers still on
        the clock."""
        return (bool(self.pending)
                or any(r is not None for r in self.active)
                or bool(self._suspended)
                or bool(self._xfers.inflight))

    def run_until_done(self, max_steps: int = 1000):
        """Drive ticks until every submitted/admitted request completes."""
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()

    def acceptance_rate(self) -> float:
        """Accepted MTP drafts over drafts made (0 before any draft)."""
        d = self.stats["drafts"]
        return self.stats["accepted_drafts"] / d if d else 0.0
