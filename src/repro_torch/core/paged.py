"""Paged decode-cache core: block pool, page tables, FP8 page storage —
port of ``repro.core.paged`` (the parts the paged serving path runs).

* **Pool layout** — per attention segment, one shared pool of fixed-size
  token pages: value leaves ``(layers, pool_pages+1, page, ...)``. The last
  page index (:func:`trash_page`) absorbs writes from freed/unmapped slots.
* **Page table** — per decode slot, ``(B, max_len // page)`` int32 of
  physical page ids (``trash`` where unmapped). Pages never ring-wrap, so
  slot ``b``'s row at logical position ``l`` is valid iff ``l <= qpos_b``.
* **FP8 storage** — one fp32 scale per token vector per layer per leaf
  (``<leaf>_scale`` leaves ``(layers, P+1, page)``); the values are E4M3
  *bytes* in ``uint8`` pools, viewed as ``torch.float8_e4m3fn`` where a
  value is needed. ``"bf16"`` storage keeps the model's native cache dtype.

JAX arrays are immutable; the port's pool writes (:func:`page_write`,
:func:`page_write_chunk`, :func:`scatter_pages`) update the pool tensor in
place, which keeps a single copy of the multi-GB pool on the card.

* **Host tier** — :class:`HostPageTier` parks suspended slots' page sets
  and cold prefix pages in host memory behind the device pool, each page
  with a CRC32 (:func:`payload_page_crcs`) checked when it comes back.
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

E4M3 = torch.float8_e4m3fn
E4M3_MAX = 448.0

STORAGES = ("fp8", "bf16")


def validate_storage(storage: str) -> str:
    if storage not in STORAGES:
        raise ValueError(
            f"unknown page storage {storage!r}; expected one of {STORAGES}")
    return storage


def trash_page(pool_pages: int) -> int:
    """Index of the scratch page (pools allocate ``pool_pages + 1``)."""
    return pool_pages


def pages_for(tokens: int, page_size: int) -> int:
    """Host-side page budget for a request that will hold ``tokens``."""
    return -(-tokens // page_size)


def pool_model_axes(leaf_name: str, ndim: int):
    """Model-axis shardability of one pool leaf, declared by name: GQA K/V
    pools ``(layers, P+1, page, KV, hd)`` can shard their KV-head axis over
    the model axis; per-token scale sidebands ``(layers, P+1, page)`` and
    the MLA latent/rope pools (no head axis: the latent is shared by every
    head) replicate. The page axis is never sharded: admission scatters
    and decode gathers index physical page ids."""
    if leaf_name in ("k", "v") and ndim == 5:
        return 3
    return None


def e4m3_decode(q: torch.Tensor) -> torch.Tensor:
    """E4M3 (or its uint8 bytes) -> fp32 through a 256-entry table indexed
    by the raw byte: bit-identical to the value cast for every code (the
    two NaN codes decode to NaN)."""
    lut = torch.arange(256, dtype=torch.uint8,
                       device=q.device).view(E4M3).float()
    u8 = q if q.dtype == torch.uint8 else q.view(torch.uint8)
    return lut[u8.long()]


def _to_store(pool: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Coerce token values to the pool's storage dtype. FP8 pools hold raw
    E4M3 bytes: quantized values (from :func:`quantize_vecs`, whose scale
    the caller writes into the scale pool alongside) are reinterpreted as
    bytes, not value-converted."""
    if pool.dtype == torch.uint8 and vals.dtype != torch.uint8:
        q = vals if vals.dtype == E4M3 else vals.to(E4M3)
        return q.view(torch.uint8)
    return vals.to(pool.dtype)


def quantize_vecs(x: torch.Tensor, vec_ndim: int = 1, reduce=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token-vector FP8 quantization: the trailing ``vec_ndim`` axes
    form one token's vector. Returns ``(q E4M3 of x's shape, scale fp32 of
    the token shape)``; bitwise equal to the reference. ``reduce`` maps
    this rank's amaxes to the whole vector's, where a mesh rank holds a
    slice of each vector (GQA K/V over their KV heads)."""
    xf = x.float()
    dims = tuple(range(x.dim() - vec_ndim, x.dim()))
    amax = xf.abs().amax(dim=dims)
    if reduce is not None:
        amax = reduce(amax)
    scale = amax.clamp_min(1e-12) / E4M3_MAX
    q = (xf / scale.reshape(scale.shape + (1,) * vec_ndim)).to(E4M3)
    return q, scale


def dequantize_vecs(q: torch.Tensor, scale: torch.Tensor,
                    vec_ndim: int = 1) -> torch.Tensor:
    """Inverse of :func:`quantize_vecs` (fp32 out)."""
    qf = (e4m3_decode(q) if q.dtype in (E4M3, torch.uint8) else q.float())
    return qf * scale.reshape(scale.shape + (1,) * vec_ndim)


# ---------------------------------------------------------------------------
# Pool read/write primitives (operate on one layer's pool slice)
# ---------------------------------------------------------------------------


def page_write(pool: torch.Tensor, table: torch.Tensor,
               positions: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Write one token per slot into the pool, in place.

    pool ``(P+1, page, ...)``; table ``(B, pages_per_slot)``; positions
    ``(B,)``; vals ``(B, ...)``. Unmapped/freed slots write to the trash
    page (their table rows point there). Returns ``pool``."""
    page = pool.shape[1]
    lp = (positions // page).clamp(0, table.shape[1] - 1).long()
    off = (positions % page).long()
    phys = table.gather(1, lp[:, None])[:, 0].long()
    pool[phys, off] = _to_store(pool, vals)
    return pool


def page_write_chunk(pool: torch.Tensor, table: torch.Tensor,
                     start: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Write a contiguous, page-aligned run of ``C`` tokens per slot, in
    place: one indexed write of ``C // page`` whole pages per slot.

    pool ``(P+1, page, ...)``; table ``(B, pages_per_slot)``; start ``(B,)``
    the run's first position, on a page boundary; vals ``(B, C, ...)`` with
    ``C`` a multiple of the page size. Pages past a slot's reservation land
    in the trash page through the table's padding, and so do pages past the
    table's end (a run that overhangs ``max_len``; the reference clamps
    those onto the slot's last page). Several pages of one run may go to
    the trash page, in an order the indexed write leaves unspecified on
    CUDA: harmless, because nothing reads the trash page unmasked. Returns
    ``pool``."""
    page = pool.shape[1]
    B, C = vals.shape[:2]
    n = C // page
    pp = table.shape[1]
    lp = start[:, None].long() // page + torch.arange(n, device=pool.device)
    phys = table.gather(1, lp.clamp(0, pp - 1)).long()
    phys = torch.where(lp < pp, phys, pool.shape[0] - 1)
    v = vals.reshape(B, n, page, *vals.shape[2:])
    pool[phys] = _to_store(pool, v)
    return pool


def table_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather each slot's pages into a dense view ``(B, pp*page, ...)`` in
    the pool dtype; rows past a slot's reservation must be masked."""
    g = pool[table.long()]
    B, pp, page = g.shape[:3]
    return g.reshape(B, pp * page, *g.shape[3:])


def gather_dequant(pool: torch.Tensor, scale_pool: torch.Tensor,
                   table: torch.Tensor, vec_ndim: int = 1) -> torch.Tensor:
    """``table_gather`` + ``dequantize_vecs`` (fp32 out): the byte pool is
    gathered first and decoded through the E4M3 table."""
    if pool.dtype in (E4M3, torch.uint8):
        u8 = pool if pool.dtype == torch.uint8 else pool.view(torch.uint8)
        vals = e4m3_decode(table_gather(u8, table))
    else:
        vals = table_gather(pool, table).float()
    s = table_gather(scale_pool, table)
    return vals * s.reshape(s.shape + (1,) * vec_ndim)


# ---------------------------------------------------------------------------
# Prefill -> pages (quantize a bucket-shaped prefill cache into page data)
# ---------------------------------------------------------------------------


def entries_to_pages(leaf: torch.Tensor, page_size: int, storage: str,
                     store_dtype: torch.dtype, vec_ndim: int = 1,
                     reduce=None) -> Dict[str, torch.Tensor]:
    """Reshape a batch-1 prefill cache leaf ``(n, 1, T, ...)`` into page
    data ``{"q": (n, T//page, page, ...)}`` plus ``{"scale": ...}`` for fp8
    storage. Pad rows (zeroed by prefill assembly) quantize to zero."""
    n, b1, T = leaf.shape[:3]
    assert b1 == 1, leaf.shape
    if T % page_size:
        raise ValueError(f"prefill capacity {T} not a multiple of the "
                         f"page size {page_size}")
    paged = leaf.reshape(n, T // page_size, page_size, *leaf.shape[3:])
    if storage == "fp8":
        q, s = quantize_vecs(paged, vec_ndim, reduce)
        return {"q": q, "scale": s}
    return {"q": paged.to(store_dtype)}


def scatter_pages(pool: torch.Tensor, pages: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """Write page data ``(n, nP, page, ...)`` into the pool ``(n, P+1,
    page, ...)`` at physical ``ids`` (nP,), all layers at once, in place
    (trash-padded ids land in the scratch page). Returns ``pool``."""
    pool[:, ids.long()] = _to_store(pool, pages)
    return pool


# ---------------------------------------------------------------------------
# Host-side page accounting: refcounts + copy-on-write prefix index
# ---------------------------------------------------------------------------


def prefix_keys(prompt: Sequence[int], page_size: int,
                n_pages: int) -> List[bytes]:
    """Exact-content index keys for a prompt's first ``n_pages`` full
    pages: key ``j`` is the byte image of ``prompt[:(j+1)*page_size]``."""
    arr = np.asarray(prompt, dtype=np.int32)
    return [arr[:(j + 1) * page_size].tobytes() for j in range(n_pages)]


class PrefixPageAllocator:
    """Refcounted physical-page allocator with a prefix -> page index.

    Host numpy bookkeeping over ``pool_pages`` physical ids (the trash page
    is outside the pool), copied from the reference. Free pages live in two
    pools: ``plain`` (unindexed) and ``cached`` (refcount-0 pages still
    holding an indexed prefix, kept warm LRU). Allocation drains plain
    first, then evicts the oldest cached page and purges its index entry.
    """

    def __init__(self, pool_pages: int):
        self.pool_pages = pool_pages
        self.refs = np.zeros((pool_pages,), np.int32)
        self._free_plain: List[int] = list(range(pool_pages))
        self._free_cached: "OrderedDict[int, bytes]" = OrderedDict()
        self._index: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        self.prefix_hits = 0
        self.prefix_lookups = 0

    def free_pages(self) -> int:
        return len(self._free_plain) + len(self._free_cached)

    def plain_free(self) -> int:
        return len(self._free_plain)

    def cached_free(self) -> int:
        return len(self._free_cached)

    def indexed_pages(self) -> int:
        return len(self._index)

    def is_indexed(self, pid: int) -> bool:
        return pid in self._page_key

    def lookup(self, key: bytes) -> Optional[int]:
        return self._index.get(key)

    def _hit_run(self, keys: Sequence[bytes], granularity: int) -> List[int]:
        hits: List[int] = []
        for key in keys:
            pid = self._index.get(key)
            if pid is None:
                break
            hits.append(pid)
        return hits[:len(hits) // granularity * granularity]

    def _take_free(self) -> int:
        if self._free_plain:
            pid = self._free_plain.pop()
        else:
            pid, key = self._free_cached.popitem(last=False)  # oldest
            del self._index[key]
            del self._page_key[pid]
        self.refs[pid] = 1
        return pid

    def can_admit(self, keys: Sequence[bytes], total_pages: int,
                  granularity: int = 1) -> bool:
        """Pure capacity probe for ``admit`` — no counters, no mutation."""
        hits = self._hit_run(keys, granularity)
        revived = sum(1 for pid in hits if self.refs[pid] == 0)
        return total_pages - len(hits) <= self.free_pages() - revived

    def admit(self, keys: Sequence[bytes], total_pages: int,
              granularity: int = 1) -> Tuple[List[int], List[int]]:
        """Claim the longest indexed run of ``keys`` and allocate fresh
        pages for the rest of ``total_pages``; raises ``RuntimeError``
        without mutating any state when capacity is short."""
        hits = self._hit_run(keys, granularity)
        n_fresh = total_pages - len(hits)
        revived = sum(1 for pid in hits if self.refs[pid] == 0)
        if n_fresh > self.free_pages() - revived:
            raise RuntimeError("no free pages")
        self.prefix_lookups += len(keys)
        self.prefix_hits += len(hits)
        for pid in hits:
            if self.refs[pid] == 0:
                del self._free_cached[pid]
            self.refs[pid] += 1
        fresh = [self._take_free() for _ in range(n_fresh)]
        return hits, fresh

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` fresh (refcount-1, unindexed) pages."""
        if n > self.free_pages():
            raise RuntimeError("no free pages")
        return [self._take_free() for _ in range(n)]

    def register(self, key: bytes, pid: int) -> bool:
        """Index a live page's content under ``key`` (first writer wins)."""
        if key in self._index:
            return False
        self._index[key] = pid
        self._page_key[pid] = key
        return True

    def release(self, ids: Sequence[int]) -> None:
        """Drop one reference per id; refcount-0 pages return to the free
        pools (cached if indexed, plain otherwise)."""
        for pid in ids:
            self.refs[pid] -= 1
            assert self.refs[pid] >= 0, f"page {pid} over-released"
            if self.refs[pid] == 0:
                key = self._page_key.get(pid)
                if key is not None:
                    self._free_cached[pid] = key
                    self._free_cached.move_to_end(pid)
                else:
                    self._free_plain.append(pid)

    def harvest(self, n: int) -> List[Tuple[int, bytes]]:
        """Pin up to ``n`` of the coldest warm-cached pages (LRU order),
        purging their index entries; the caller releases them later."""
        out: List[Tuple[int, bytes]] = []
        while self._free_cached and len(out) < n:
            pid, key = self._free_cached.popitem(last=False)  # oldest
            del self._index[key]
            del self._page_key[pid]
            self.refs[pid] = 1
            out.append((pid, key))
        return out


# ---------------------------------------------------------------------------
# Host-memory page tier
# ---------------------------------------------------------------------------

# Residency states of a tier entry. A page set starts on DEVICE (no entry),
# enters SPILLING when a host reservation is made and the device->host
# transfer is in flight, becomes HOST once the bytes are durable, and
# FETCHING while a host->device transfer is in flight; a completed fetch
# frees the entry (back to DEVICE). Transitions outside this cycle raise.
TIER_SPILLING = "spilling"
TIER_HOST = "host"
TIER_FETCHING = "fetching"

_TIER_TRANSITIONS = {
    (TIER_SPILLING, TIER_HOST),     # commit
    (TIER_HOST, TIER_FETCHING),     # begin_fetch
    (TIER_FETCHING, TIER_HOST),     # abort_fetch (retry / preempted fetch)
}


def payload_leaves(payload: Any) -> List[Any]:
    """The leaves of a payload tree (dicts of CPU tensors or numpy arrays)
    in the reference's order: ``jax.tree.leaves`` walks dict keys
    sorted."""
    if isinstance(payload, dict):
        return [x for k in sorted(payload) for x in payload_leaves(payload[k])]
    return [] if payload is None else [payload]


def _host_bytes(leaf: Any) -> np.ndarray:
    """A leaf's bytes in C order as a uint8 array. A tensor is read through
    a ``uint8`` view (numpy has no E4M3), so an E4M3 tensor and the same
    codes held as uint8 (the port's fp8 pools) give the same bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().reshape(-1)
        return t.view(torch.uint8).numpy()
    return np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)


def payload_page_crcs(payload: Any, n_pages: int) -> List[int]:
    """CRC32 per page over a gathered page payload whose leaves are
    ``(layers, n_pages, page, ...)``. Page ``j``'s checksum folds that
    page's bytes of every leaf, leaves in :func:`payload_leaves` order,
    so a flipped byte anywhere in a spilled page is caught at fetch time;
    the same bytes give the reference's checksums."""
    crcs = [0] * n_pages
    for leaf in payload_leaves(payload):
        # the page axis first: each page's bytes, layers outermost, are
        # then one contiguous run, the order of the leaf's ``[:, j]``
        if isinstance(leaf, torch.Tensor):
            pages = leaf.detach().movedim(1, 0).contiguous()
        else:
            pages = np.ascontiguousarray(np.moveaxis(np.asarray(leaf), 1, 0))
        buf = _host_bytes(pages).reshape(pages.shape[0], -1)
        for j in range(n_pages):
            crcs[j] = zlib.crc32(buf[j], crcs[j])
    return crcs


def payload_crc(payload: Any) -> int:
    """Single CRC32 over a whole payload tree (aux leaves, one page)."""
    crc = 0
    for leaf in payload_leaves(payload):
        crc = zlib.crc32(_host_bytes(leaf), crc)
    return crc


def payload_nbytes(payload: Any) -> int:
    """Total byte size of a payload tree (transfer accounting)."""
    return sum(leaf.numel() * leaf.element_size()
               if isinstance(leaf, torch.Tensor) else np.asarray(leaf).nbytes
               for leaf in payload_leaves(payload))


class TierEntry:
    """One suspended slot's page set parked in (or moving through) the
    host tier. Payloads are opaque trees of host tensors; the tier
    validates residency transitions and capacity, nothing else."""

    __slots__ = ("eid", "n_pages", "state", "payload", "aux", "crcs",
                 "aux_crc")

    def __init__(self, eid: int, n_pages: int):
        self.eid = eid
        self.n_pages = n_pages
        self.state = TIER_SPILLING
        self.payload: Any = None
        self.aux: Any = None
        self.crcs: List[int] = []
        self.aux_crc: int = 0


class HostPageTier:
    """Host-side page store behind the device pool, copied from the
    reference.

    Capacity is counted in pages. Two kinds of content share it:

    * **Slot entries** — a suspended request's whole page set plus its
      decode aux leaves, reserved atomically via :meth:`reserve` and
      tracked through the SPILLING -> HOST -> FETCHING state machine.
    * **Prefix pages** — individual refcount-0 warm-LRU pages harvested
      from the device allocator's prefix cache, one page each, kept in
      their own LRU. They are cache copies, not the only copy, so they are
      always evictable: a slot reservation squeezes the oldest prefix
      pages out first.

    Every spilled page carries a CRC32 (:func:`payload_page_crcs`) checked
    at fetch time; the tier never touches a device buffer — staging
    device<->host is the caller's job (``serve/tier.py``).
    """

    def __init__(self, capacity_pages: int):
        if capacity_pages <= 0:
            raise ValueError(f"host tier needs capacity > 0, "
                             f"got {capacity_pages}")
        self.capacity_pages = capacity_pages
        self._entries: Dict[int, TierEntry] = {}
        self._next_eid = 0
        # key -> (payload, crc); insertion order is LRU order
        self._prefix: "OrderedDict[bytes, Tuple[Any, int]]" = OrderedDict()
        self.prefix_evictions = 0

    # -- capacity ----------------------------------------------------------

    def slot_pages(self) -> int:
        return sum(e.n_pages for e in self._entries.values())

    def prefix_pages(self) -> int:
        return len(self._prefix)

    def used_pages(self) -> int:
        return self.slot_pages() + self.prefix_pages()

    def free_pages(self) -> int:
        return self.capacity_pages - self.used_pages()

    def occupancy(self) -> float:
        return self.used_pages() / self.capacity_pages

    def entries(self) -> int:
        return len(self._entries)

    def host_bytes(self) -> int:
        """Bytes of the page sets, aux leaves and prefix pages held now."""
        return sum(payload_nbytes(e.payload) + payload_nbytes(e.aux)
                   for e in self._entries.values()) + sum(
            payload_nbytes(pg) for pg, _ in self._prefix.values())

    # -- slot entries ------------------------------------------------------

    def reserve(self, n_pages: int) -> Optional[int]:
        """Reserve ``n_pages`` for a suspending slot; returns an entry id
        (state SPILLING) or None when the tier cannot fit it. Oldest
        prefix pages are evicted to make room — they are cache copies and
        a suspension is the only copy."""
        if n_pages > self.capacity_pages:
            return None
        while self.free_pages() < n_pages and self._prefix:
            self._prefix.popitem(last=False)
            self.prefix_evictions += 1
        if self.free_pages() < n_pages:
            return None
        eid = self._next_eid
        self._next_eid += 1
        self._entries[eid] = TierEntry(eid, n_pages)
        return eid

    def _entry(self, eid: int, *states: str) -> TierEntry:
        e = self._entries.get(eid)
        if e is None:
            raise KeyError(f"tier entry {eid} does not exist")
        if states and e.state not in states:
            raise ValueError(f"tier entry {eid} is {e.state}, "
                             f"expected one of {states}")
        return e

    def _transition(self, e: TierEntry, to: str) -> None:
        if (e.state, to) not in _TIER_TRANSITIONS:
            raise ValueError(f"illegal tier transition {e.state} -> {to} "
                             f"for entry {e.eid}")
        e.state = to

    def commit(self, eid: int, payload: Any, aux: Any,
               crcs: Sequence[int], aux_crc: int) -> None:
        """Land a spill: SPILLING -> HOST with the page bytes durable."""
        e = self._entry(eid, TIER_SPILLING)
        if len(crcs) != e.n_pages:
            raise ValueError(f"entry {eid}: {len(crcs)} CRCs for "
                             f"{e.n_pages} pages")
        self._transition(e, TIER_HOST)
        e.payload, e.aux, e.crcs, e.aux_crc = payload, aux, list(crcs), aux_crc

    def begin_fetch(self, eid: int) -> TierEntry:
        """HOST -> FETCHING; returns the entry (payload/crcs readable)."""
        e = self._entry(eid, TIER_HOST)
        self._transition(e, TIER_FETCHING)
        return e

    def abort_fetch(self, eid: int) -> None:
        """FETCHING -> HOST (failed/preempted fetch keeps the host copy)."""
        e = self._entry(eid, TIER_FETCHING)
        self._transition(e, TIER_HOST)

    def state(self, eid: int) -> str:
        return self._entry(eid).state

    def free(self, eid: int) -> None:
        """Drop an entry in any state (fetch completed, cancel, degrade)."""
        self._entry(eid)
        del self._entries[eid]

    # -- prefix page cache -------------------------------------------------

    def put_prefix(self, key: bytes, payload: Any, crc: int) -> bool:
        """Park one harvested prefix page under ``key``. Evicts older
        prefix pages LRU to fit, never slot entries; returns False when
        slot entries alone leave no room."""
        if key in self._prefix:
            self._prefix.move_to_end(key)
            return True
        while self.free_pages() < 1 and self._prefix:
            self._prefix.popitem(last=False)
            self.prefix_evictions += 1
        if self.free_pages() < 1:
            return False
        self._prefix[key] = (payload, crc)
        return True

    def prefix_run(self, keys: Sequence[bytes], granularity: int = 1) -> int:
        """Length (pages, rounded down to ``granularity``) of the leading
        contiguous run of ``keys`` present in the prefix cache."""
        n = 0
        for key in keys:
            if key not in self._prefix:
                break
            n += 1
        return n // granularity * granularity

    def take_prefix(self, keys: Sequence[bytes]
                    ) -> List[Tuple[Any, int]]:
        """Read ``(payload, crc)`` per key (all must be present), touching
        each entry to MRU. Entries stay cached — a fetch copies them back
        to the device, it does not remove the host copy."""
        out = []
        for key in keys:
            if key not in self._prefix:
                raise KeyError("prefix page vanished from the tier")
            self._prefix.move_to_end(key)
            out.append(self._prefix[key])
        return out

    def drop_prefix(self, key: bytes) -> None:
        self._prefix.pop(key, None)
