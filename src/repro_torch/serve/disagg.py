"""Prefill/decode disaggregation (paper §2.3.1 / DistServe) — port of
``repro.serve.disagg``.

Production DeepSeek-V3 assigns large-batch prefill and latency-sensitive
decode to *different* expert-parallel group sizes. This module models that
split: a prefill pool and a decode pool connected by a cache-handoff queue
— the KV-cache transfer the paper's §4.5 flags as a PCIe contention
source. Prefill goes through an engine's bucketed prefill, admission
through the decode engine's slot splice (dense) or page scatter (paged),
and decode through its fused ``chunk``-step decode graph.

Handoff bytes are tracked per request. With ``paged=True`` the handoff
ships the quantized page payload (``Model.prefill_to_pages``: E4M3 pages
and per-token scales, sized to the prompt's bucket rather than a full
``max_len`` ring, and the slot-resident aux leaves: an enc-dec request's
encoder memory among them), so ``cache_nbytes`` reports the bytes a wire
would carry. A request's ``extras`` (frames or patches) go to the prefill
pool; the payload carries what decode needs of them.

**Cross-mesh** (the paper's deployment: prefill and decode on
expert-parallel groups of different sizes): ``ctx=`` is the decode mesh,
``prefill_ctx=`` the prefill mesh. With a ``prefill_ctx`` the prefill pool
is an engine of its own on its own mesh (one slot, and an empty page pool
when paged: it only prefills and quantizes). Both pools draw one
parameter set (the given ``params``, or the same seed), each placed by
its own mesh's serving rules. Each handoff payload is made whole on the
prefill mesh (``ServeEngine.whole_payload``: the model group's cuts
gathered), crosses through host memory (``serve/tier.staged_get``, the
crossing the KV tier audits too) and is cut for the decode mesh at
admission (``ServeEngine.local_payload``): the GQA K/V heads, the
recurrent states and conv tails alike, and a memory leaf as it is;
``handoff_bytes`` is exactly what crosses. Every rank of the deployment runs the same calls in the
same order (explicit SPMD), and every rank must be on the prefill mesh:
prefill is replicated over its data rows and the whole payload is the
same on every prefill rank, so each decode rank takes its own copy, and
a rank outside the decode mesh runs prefill only (``decode`` is None
there, and ``step``/``run`` do nothing). A decode rank outside the
prefill mesh would need the payload sent to it; that raises.
``ctx=`` alone gives a meshed decode pool that prefills itself.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serve import tier as tier_mod
from repro_torch.serve.engine import (AdmissionError, Request, ServeEngine,
                                      validate_request)


def cache_nbytes(cache) -> int:
    """Wire bytes of a handoff payload (a dense batch-1 cache tree, or a
    paged engine's quantized page payload — pages, scales and aux)."""
    if isinstance(cache, dict):
        return sum(cache_nbytes(v) for v in cache.values())
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    return 0


@dataclasses.dataclass
class Handoff:
    req: Request
    cache1: object        # dense: batch-1, max_len-row cache tree;
                          # paged: quantized page payload (wire format)
    first_token: int
    nbytes: int


def _on(ctx) -> bool:
    """This rank holds a position on ``ctx``'s mesh (always unmeshed)."""
    return ctx is None or ctx.mesh is None or ctx.mesh.rank is not None


class Disaggregator:
    """Two-pool serving: a prefill instance and a decode instance with an
    explicit cache handoff (the paper's disaggregated deployment). Without
    ``prefill_ctx`` both pools are one engine (the EP sizes are recorded
    for the performance models); with it, two engines on two meshes
    (module docstring)."""

    def __init__(self, cfg: ModelConfig, params=None, decode_slots: int = 4,
                 max_len: int = 128, prefill_ep: int = 32,
                 decode_ep: int = 128, use_mtp: bool = False,
                 chunk: int = 8, temperature: float = 0.0, top_k: int = 0,
                 paged: bool = False, page_size: int = 8,
                 pool_pages: Optional[int] = None,
                 page_storage: str = "fp8",
                 max_queue: Optional[int] = None,
                 ctx=None, prefill_ctx=None,
                 attn_impl: str = "", device=None):
        self.prefill_ep = prefill_ep
        self.decode_ep = decode_ep
        common = dict(max_len=max_len, use_mtp=use_mtp, chunk=chunk,
                      temperature=temperature, top_k=top_k, paged=paged,
                      page_size=page_size, page_storage=page_storage,
                      attn_impl=attn_impl, device=device)
        if not _on(prefill_ctx if prefill_ctx is not None else ctx):
            raise ValueError(
                "a rank outside the prefill mesh: the handoff reaches a "
                "decode rank only as its own prefill rank's copy, so every "
                "rank of the deployment must be on the prefill mesh")
        # the decode pool's admission limits, checked on every rank (a
        # prefill-only rank must refuse what the decode ranks refuse)
        self._limits = None if not paged else (
            max_len, page_size, pool_pages if pool_pages is not None
            else decode_slots * (max_len // page_size))
        self.decode = (ServeEngine(cfg, params=params, slots=decode_slots,
                                   pool_pages=pool_pages, ctx=ctx, **common)
                       if _on(ctx) else None)
        if prefill_ctx is not None:
            if max_queue is not None and (
                    ctx is None or ctx.mesh is None
                    or ctx.mesh.size != prefill_ctx.mesh.size):
                raise ValueError(
                    "max_queue with prefill and decode on different rank "
                    "sets: a prefill-only rank cannot see the decode "
                    "pool's queue drain")
            # the prefill pool never admits: one slot and, paged, an empty
            # page pool (the trash page alone)
            self.prefill_pool = ServeEngine(
                cfg, params=params, slots=1, ctx=prefill_ctx,
                pool_pages=0 if paged else pool_pages, **common)
        else:
            self.prefill_pool = self.decode
        engine = self.decode if self.decode is not None else \
            self.prefill_pool
        self.params = engine.params
        self.model = engine.model
        self.queue: Deque[Handoff] = collections.deque()
        self.max_queue = max_queue
        self.handoff_bytes = 0

    @property
    def cross_mesh(self) -> bool:
        """True when prefill and decode run as separate engines (possibly
        on different meshes) and handoffs stage through host memory."""
        return self.prefill_pool is not self.decode

    def submit(self, req: Request, extras: Optional[Dict] = None):
        """Run prefill (prefill pool) and queue the cache for decode. With
        ``max_queue`` set, a full handoff queue raises ``AdmissionError``
        *before* spending prefill compute on a request the decode pool
        cannot accept — backpressure at the cheapest point. Cross-mesh,
        the payload crosses to host memory here, whole; a prefill-only
        rank drops it."""
        if self._limits is not None:
            validate_request(req, *self._limits)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise AdmissionError(
                f"handoff queue full: request {req.rid} rejected; "
                f"{len(self.queue)} prefilled handoffs queued >= max_queue "
                f"({self.max_queue}) — drive step() to drain the decode "
                "pool first")
        first, cache1 = self.prefill_pool.prefill_request(req, extras)
        if self.cross_mesh:
            cache1 = tier_mod.staged_get(
                self.prefill_pool.whole_payload(cache1))
            if self.decode is None:
                return
        self.queue.append(Handoff(req, cache1, first, cache_nbytes(cache1)))

    def admit(self):
        """Move queued prefilled requests into free decode slots (paged
        engines also wait for enough pool pages — FIFO head-of-line).
        Cross-mesh, each payload is cut for this decode rank and staged
        back onto its device."""
        while self.queue and self.decode.can_admit(self.queue[0].req):
            h = self.queue.popleft()
            slot = self.decode.free_slots()[0]
            payload = h.cache1
            if self.cross_mesh:
                payload = tier_mod.staged_put(
                    self.decode.local_payload(payload), self.decode.device)
            self.decode.admit_prefilled(h.req, h.first_token, payload, slot)
            self.handoff_bytes += h.nbytes

    def step(self):
        if self.decode is None:
            return
        self.admit()
        self.decode.step()

    def run(self, max_steps: int = 1000):
        for _ in range(max_steps if self.decode is not None else 0):
            if not self.queue and not any(
                    r is not None for r in self.decode.active):
                break
            self.step()
