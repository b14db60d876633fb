"""Prefill/decode disaggregation (paper §2.3.1 / DistServe) — port of
``repro.serve.disagg``.

Production DeepSeek-V3 assigns large-batch prefill and latency-sensitive
decode to *different* expert-parallel group sizes. This module models that
split: a prefill pool and a decode pool connected by a cache-handoff queue
— the KV-cache transfer the paper's §4.5 flags as a PCIe contention
source. Prefill goes through the decode engine's bucketed prefill,
admission through its slot splice (dense) or page scatter (paged), and
decode through its fused ``chunk``-step decode graph.

Handoff bytes are tracked per request. With ``paged=True`` the handoff
ships the quantized page payload (``Model.prefill_to_pages``: E4M3 pages
and per-token scales, sized to the prompt's bucket rather than a full
``max_len`` ring), so ``cache_nbytes`` reports the bytes a wire would
carry.

The reference's cross-mesh form (``ctx=`` / ``prefill_ctx=``: two engines
over two meshes, the payload staged through host memory between them)
waits for the port's meshes and raises.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serve.engine import (AdmissionError, Request, ServeEngine,
                                      _waits)


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


class Disaggregator:
    """Two-pool serving: a prefill instance and a decode instance with an
    explicit cache handoff (the paper's disaggregated deployment). Both
    pools are one engine on one device; the EP sizes are recorded for the
    performance models."""

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
        if ctx is not None:
            raise _waits("ctx=: a mesh-sharded decode pool", "A.8",
                         "Disaggregator")
        if prefill_ctx is not None:
            raise _waits("prefill_ctx=: cross-mesh disaggregation", "A.8",
                         "Disaggregator")
        self.prefill_ep = prefill_ep
        self.decode_ep = decode_ep
        self.decode = ServeEngine(cfg, params=params, slots=decode_slots,
                                  max_len=max_len, use_mtp=use_mtp,
                                  chunk=chunk, temperature=temperature,
                                  top_k=top_k, paged=paged,
                                  page_size=page_size,
                                  pool_pages=pool_pages,
                                  page_storage=page_storage,
                                  attn_impl=attn_impl, device=device)
        self.prefill_pool = self.decode
        self.params = self.decode.params
        self.model = self.decode.model
        self.queue: Deque[Handoff] = collections.deque()
        self.max_queue = max_queue
        self.handoff_bytes = 0

    @property
    def cross_mesh(self) -> bool:
        """True when prefill and decode run as separate engines; never in
        the port yet (see the module docstring)."""
        return self.prefill_pool is not self.decode

    def submit(self, req: Request, extras: Optional[Dict] = None):
        """Run prefill (prefill pool) and queue the cache for decode. With
        ``max_queue`` set, a full handoff queue raises ``AdmissionError``
        *before* spending prefill compute on a request the decode pool
        cannot accept — backpressure at the cheapest point."""
        self.decode._validate(req)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise AdmissionError(
                f"handoff queue full: request {req.rid} rejected; "
                f"{len(self.queue)} prefilled handoffs queued >= max_queue "
                f"({self.max_queue}) — drive step() to drain the decode "
                "pool first")
        first, cache1 = self.prefill_pool.prefill_request(req, extras)
        self.queue.append(Handoff(req, cache1, first, cache_nbytes(cache1)))

    def admit(self):
        """Move queued prefilled requests into free decode slots (paged
        engines also wait for enough pool pages — FIFO head-of-line)."""
        while self.queue and self.decode.can_admit(self.queue[0].req):
            h = self.queue.popleft()
            slot = self.decode.free_slots()[0]
            self.decode.admit_prefilled(h.req, h.first_token, h.cache1, slot)
            self.handoff_bytes += h.nbytes

    def step(self):
        self.admit()
        self.decode.step()

    def run(self, max_steps: int = 1000):
        for _ in range(max_steps):
            if not self.queue and not any(
                    r is not None for r in self.decode.active):
                break
            self.step()
