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
:func:`scatter_pages`) update the pool tensor in place, which keeps a
single copy of the multi-GB pool on the card.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

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


def quantize_vecs(x: torch.Tensor, vec_ndim: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token-vector FP8 quantization: the trailing ``vec_ndim`` axes
    form one token's vector. Returns ``(q E4M3 of x's shape, scale fp32 of
    the token shape)``; bitwise equal to the reference."""
    xf = x.float()
    dims = tuple(range(x.dim() - vec_ndim, x.dim()))
    amax = xf.abs().amax(dim=dims)
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
                     store_dtype: torch.dtype,
                     vec_ndim: int = 1) -> Dict[str, torch.Tensor]:
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
        q, s = quantize_vecs(paged, vec_ndim)
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
