"""Paged serving engine — port of ``repro.serve.engine.ServeEngine`` for
single-device paged serving (paper §2.1.2 quantized latent cache, §2.3.2
memory-bound decode).

One shared pool of fixed-size token pages per attention segment, per-slot
page tables, page-granular admission: a request reserves
``ceil((prompt + max_new) / page_size)`` pages and ``submit()`` admits it
when a slot *and* its pages are free. Admission is bucketed prefill
(``Model.prefill``) -> ``prefill_to_pages`` (E4M3 values + per-token
scales under ``page_storage="fp8"``) -> ``admit_pages``. ``step()`` then
runs ``chunk`` fused decode steps (``Model.decode_loop``) over the
decoding slots and reads the emitted tokens back once per chunk. A freed
slot's pages return to the pool and its table row points at the trash
page, so its masked decode lane never writes into recycled pages.

Options of the reference that the port has not reached raise
``NotImplementedError`` with a pointer to ROADMAP.md: the dense cache
(``paged=False``), mesh contexts, chunked prefill, the host KV tier,
decode overlap and MTP drafting. Priority preemption and ``cancel`` come
with the scheduler; requests admit in priority order, FIFO within a class.
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
    priority: int = 0            # higher admits first; FIFO within a class
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


def _waits(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"ServeEngine({what}) is not ported yet: see ROADMAP.md, {item}")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class ServeEngine:
    """Fixed-slot paged batch engine (continuous batching-lite)."""

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
        if not paged:
            raise _waits("paged=False: the dense ring cache", "A.5")
        if ctx is not None:
            raise _waits("ctx=: mesh-sharded serving", "A.8")
        if prefill_chunk is not None:
            raise _waits("prefill_chunk=: chunked prefill", "A.5")
        if (host_tier_pages is not None or tier_config is not None
                or tier_faults is not None):
            raise _waits("host_tier_pages=: the host KV tier", "A.6")
        if decode_overlap:
            raise _waits("decode_overlap=True", "A.8")
        if use_mtp:
            raise _waits("use_mtp=True: MTP drafting", "A.4")
        paged_mod.validate_storage(page_storage)
        self.cfg = cfg
        self.model = Model(cfg, device)
        self.device = self.model.device
        if attn_impl:
            # "pallas": paged decode attention through the kernel registry
            self.model.impl_ctx = {"mla_impl": attn_impl}
        self.attn_impl = attn_impl
        if params is None:
            # the engine owns these weights: prepare them in place
            self.params = prepare_for_serving(self.model.init(seed), cfg,
                                              inplace=True)
        else:
            self.params = prepare_for_serving(
                _to_device(params, self.device), cfg)
        self.slots = slots
        self.max_len = max_len
        self.chunk = chunk
        self.temperature = temperature
        self.top_k = top_k
        self.page_size = page_size
        self.pages_per_slot = max_len // page_size
        self.pool_pages = (pool_pages if pool_pages is not None
                           else slots * self.pages_per_slot)
        self.page_storage = page_storage
        self.cache = self.model.init_paged_cache(
            slots, max_len, page_size, self.pool_pages, page_storage)
        self._alloc = paged_mod.PrefixPageAllocator(self.pool_pages)
        self._slot_pages: List[List[int]] = [[] for _ in range(slots)]
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
        self._hol_skips = 0
        self._seed_gen = np.random.default_rng(seed + 1)
        self.stats = {"steps": 0, "tokens": 0, "dispatches": 0,
                      "prefills": 0, "first_tokens": 0, "page_admits": 0,
                      "page_releases": 0, "peak_pages_used": 0}

    # -- prefill ------------------------------------------------------------
    def prefill_request(self, req: Request, extras: Optional[Dict] = None):
        """Bucketed prefill of one request; returns ``(first_token,
        payload)`` with the quantized page payload of
        ``Model.prefill_to_pages``. Requests with delivered tokens
        (continuations) prefill prompt+delivered and sample at the advanced
        stream offset."""
        if extras:
            raise _waits("extras: encoder/vision payloads", "A.10")
        prompt, _, offset = self._effective(req)
        L = len(prompt)
        bucket = bucket_length(L, self.max_len)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :L] = prompt
        self.stats["dispatches"] += 1
        self.stats["prefills"] += 1
        logits, cache1 = self.model.prefill(
            self.params, {"tokens": torch.as_tensor(toks)},
            lengths=np.asarray([L], np.int32))
        payload = self.model.prefill_to_pages(cache1, self.page_size,
                                              self.page_storage)
        seed = torch.as_tensor([self._request_seed(req)], device=self.device)
        tix = torch.as_tensor([offset], dtype=torch.int32, device=self.device)
        first = sample_logits(logits[:, -1], seed, tix, self.temperature,
                              self.top_k)
        # the admission needs the token on the host: one sync per prefill
        return int(first.cpu()[0]), payload

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
        """Allocatable pages in the pool."""
        return self._alloc.free_pages()

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

    def can_admit(self, req: Request) -> bool:
        return bool(self.free_slots()) and \
            self.pages_needed(req) <= self.free_pages()

    def _validate(self, req: Request):
        if len(req.prompt) + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + max_new "
                f"({req.max_new}) exceeds max_len ({self.max_len}); the "
                "paged cache never ring-wraps")
        if self.pages_needed(req) > self.pool_pages:
            raise ValueError(
                f"request {req.rid}: needs {self.pages_needed(req)} pages "
                f"but the pool only has {self.pool_pages}")

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
        """Admit a prefilled request into ``slot``: reserve its pages,
        scatter its quantized prefill pages, install its page-table row and
        the host mirrors. A request finished by its first token (budget 1
        or an immediate EOS) reserves nothing."""
        prompt, max_new, offset = self._effective(req)
        finishes = (max_new <= 1
                    or (req.eos is not None and first == req.eos))
        n = paged_mod.pages_for(len(prompt) + max_new, self.page_size)
        if not finishes and n > self.free_pages():
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
        alloc = self._alloc.alloc(n)
        self._slot_pages[slot] = alloc
        trash = self.pool_pages
        row = np.full((self.pages_per_slot,), trash, np.int32)
        row[:n] = alloc
        # prefill pages beyond the reservation (bucket > budget) land in
        # the trash page
        n_p = payload["pages"][self.model.segments[0].name]["ckv"].shape[1]
        ids = np.asarray([alloc[i] if i < n else trash for i in range(n_p)],
                         np.int64)
        self.stats["page_admits"] += 1
        self.stats["peak_pages_used"] = max(
            self.stats["peak_pages_used"], self.pool_pages - self.free_pages())
        self.model.admit_pages(self.cache, payload["pages"], ids, row, slot)
        self.positions[slot] = len(prompt)
        self._tokens[slot] = first
        self._left[slot] = max_new - 1
        self._eos[slot] = -1 if req.eos is None else req.eos
        self._seeds[slot] = self._request_seed(req)
        self._tix[slot] = offset + 1     # prefill drew stream index offset
        self.active[slot] = req

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

    def _admit_pending(self) -> int:
        admitted = 0
        while self.pending:
            i = self._pick_admission()
            if i is None:
                break
            req, extras = self.pending[i]
            del self.pending[i]
            first, payload = self.prefill_request(req, extras)
            self.admit_prefilled(req, first, payload, self.free_slots()[0])
            admitted += 1
        return admitted

    # -- decode -------------------------------------------------------------
    def _device_state(self) -> Dict[str, torch.Tensor]:
        """Decode state from the host mirrors, in one host-to-device copy."""
        active = np.array([r is not None for r in self.active], np.int64)
        host = np.stack([self._tokens, self.positions, active, self._left,
                         self._eos, self._tix, self._seeds]).astype(np.int64)
        dev = torch.as_tensor(host).to(self.device)
        i32 = dev[:6].int()
        return dict(tokens=i32[0], positions=i32[1], active=dev[2] > 0,
                    left=i32[3], eos=i32[4], tix=i32[5], seeds=dev[6])

    def step(self):
        """One scheduler tick: admit from the pending queue, then one fused
        ``chunk``-step decode over the decoding slots and one read-back."""
        self._admit_pending()
        if not any(r is not None for r in self.active):
            return
        self.stats["dispatches"] += 1
        toks, emitted, self.cache, st = self.model.decode_loop(
            self.params, self.cache, self._device_state(), self.chunk,
            temperature=self.temperature, top_k=self.top_k)
        # the one host sync per chunk: emitted tokens + slot state, packed
        # into one tensor and copied back together
        packed = torch.cat([toks, emitted.int(),
                            torch.stack([st["tokens"], st["positions"],
                                         st["active"].int(), st["left"],
                                         st["tix"]], dim=1)], dim=1).cpu()
        host = packed.numpy()
        k = self.chunk
        toks, emitted = host[:, :k], host[:, k:2 * k].astype(bool)
        tokens, positions, active, left, tix = host[:, 2 * k:].T
        self.stats["steps"] += int(emitted.any(axis=0).sum())
        self._tokens = tokens.astype(np.int32)
        self.positions = positions.astype(np.int32)
        self._left = left.astype(np.int32)
        self._tix = tix.astype(np.int32)
        for i, r in enumerate(self.active):
            if r is None:
                continue
            new = toks[i, emitted[i]]
            r.out.extend(int(t) for t in new)
            self.stats["tokens"] += int(new.size)
            if not active[i]:
                r.done = True
                self._release_slot(i)

    def _release_slot(self, slot: int):
        """Free ``slot``: clear occupancy, return its whole page reservation
        to the pool, and point its table row at the trash page."""
        self.active[slot] = None
        if self._slot_pages[slot]:
            self._alloc.release(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self.stats["page_releases"] += 1
            self.model.release_slot_pages(self.cache, slot)

    # -- introspection --------------------------------------------------------
    def pool_stats(self) -> Dict[str, Any]:
        free = self.free_pages()
        used = self.pool_pages - free
        return dict(pages_total=self.pool_pages, pages_free=free,
                    pages_used=used,
                    occupancy=used / self.pool_pages if self.pool_pages
                    else 0.0)

    def cache_bytes_per_token(self) -> float:
        """Attention-cache bytes per token of context capacity (the paper's
        Table 1 lever): pool pages (values + scales, trash page excluded)
        over ``pool_pages * page_size`` tokens, plus the page table."""
        per_page = sum(
            t.numel() * t.element_size() / (self.pool_pages + 1)
            for seg in self.model.segments
            for t in self.cache[seg.name].values())
        table = self.cache["page_table"]
        return per_page / self.page_size + (
            table.numel() * table.element_size()
            / (self.slots * self.max_len))

    def has_work(self) -> bool:
        return bool(self.pending) or any(r is not None for r in self.active)

    def run_until_done(self, max_steps: int = 1000):
        """Drive ticks until every submitted/admitted request completes."""
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
