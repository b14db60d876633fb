"""Device<->host staging and the transfer clock of the KV page tier — port
of ``repro.serve.tier``.

The host tier (``core/paged.HostPageTier``) turns the device page pool
into a cache: suspended slots and cold prefix pages park in host memory
and come back on demand. Every byte that crosses the boundary, and every
prefill/decode handoff that stages through the host, goes through
:func:`staged_get` and :func:`staged_put` and nowhere else, between engine
ticks, so the transfer volume stays auditable (the §4.5 PCIe hop):

* ``staged_get``: every leaf copied into pinned host memory on the
  current stream, then one host wait — the counterpart of the reference's
  ``jax.device_get``. On the CPU each leaf is copied, so the payload never
  aliases a cache leaf that is later written in place.
* ``staged_put``: a non-blocking copy from pinned memory to the device,
  queued on the current stream, so the caller's in-place scatter that
  follows, and every later graph replay, read the bytes after they land.
  The caching host allocator keeps a pinned block until the copies queued
  from it have run, so the payload may be dropped at once.

Transfers are modelled on the engine's tick clock by
:class:`TransferClock`, unchanged from the reference: each in-flight
:class:`TierTransfer` counts down an ETA (stretched by an injected
``pcie_slow`` factor), a completion attempt can be failed by ``pcie_drop``
(bounded retry with exponential backoff), and a transfer that outlives
``timeout_ticks`` escalates to a hard failure — the engine's degradation
ladder (resume-in-place for spills, continuation re-queue for fetches)
takes over from there. The copies themselves happen when the engine
gathers (suspension) and installs (a landed fetch), so the clock decides
when a transfer counts as landed, not how long the copy took.

Payloads are trees (dicts) of CPU tensors whose page axis is axis 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def staged_get(tree: Any) -> Any:
    """Stage a device tree to host tensors: one copy per leaf into pinned
    memory (device leaves) or a plain copy (CPU leaves), then one wait."""
    def get(t):
        if not t.is_cuda:
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    out = _tree_map(get, tree)
    devs = {t.device for t in _leaves(tree) if t.is_cuda}
    for dev in devs:
        torch.cuda.current_stream(dev).synchronize()
    return out


def staged_put(tree: Any, device: torch.device) -> Any:
    """Stage a host tree onto ``device``: a non-blocking copy per leaf from
    pinned memory (a pageable leaf is pinned first), queued on the current
    stream. On the CPU the tree is returned as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return tree

    def put(t):
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    return _tree_map(put, tree)


@dataclasses.dataclass
class TierConfig:
    """Knobs for the tier's transfer model and scheduler policy."""
    xfer_ticks: int = 1        # base ticks per device<->host transfer
    max_retries: int = 3       # completion attempts after the first
    timeout_ticks: int = 32    # hard escalation: transfer age limit
    quantum: int = 8           # decode ticks a resident runs before it can
                               # be rotated out for a waiter
    harvest_batch: int = 4     # warm-LRU prefix pages spilled per sweep


class NullFaultHook:
    """Fault hook that never fires (the no-chaos default)."""

    def on_tick(self) -> None:
        pass

    def drop(self) -> bool:
        return False

    def slow(self) -> float:
        return 1.0

    def full(self) -> bool:
        return False


# transfer kinds
SPILL = "spill"              # suspended slot: device -> host
FETCH = "fetch"              # suspended slot: host -> device
PREFIX_SPILL = "prefix-spill"  # harvested warm prefix pages -> host
PREFIX_FETCH = "prefix-fetch"  # tier prefix hit -> fresh device pages


@dataclasses.dataclass
class TierTransfer:
    """One in-flight device<->host page transfer on the tick clock."""
    kind: str
    rid: Optional[int]             # owning request (None for prefix spills)
    eid: Optional[int]             # HostPageTier entry id (slot transfers)
    nbytes: int
    eta: int                       # ticks until the current attempt lands
    meta: dict = dataclasses.field(default_factory=dict)
    retries: int = 0
    backoff: int = 0
    age: int = 0
    failure: Optional[str] = None  # set when the clock gives up


class TransferClock:
    """Advances in-flight transfers once per engine tick.

    ``advance(hook)`` returns ``(completed, failed)``: transfers whose
    attempt landed this tick, and transfers that exhausted their retry
    budget or outlived the timeout. The caller finalizes completions (the
    pool install, the tier commit) and walks failures down the
    degradation ladder.
    """

    def __init__(self, cfg: TierConfig):
        self.cfg = cfg
        self.inflight: List[TierTransfer] = []
        self.retries = 0
        self.timeouts = 0

    def submit(self, kind: str, rid: Optional[int], eid: Optional[int],
               nbytes: int, slow: float = 1.0, **meta) -> TierTransfer:
        eta = max(1, math.ceil(self.cfg.xfer_ticks * slow))
        t = TierTransfer(kind=kind, rid=rid, eid=eid, nbytes=nbytes,
                         eta=eta, meta=meta)
        self.inflight.append(t)
        return t

    def cancel(self, pred) -> List[TierTransfer]:
        """Drop in-flight transfers matching ``pred`` (cancelled request);
        returns them so the caller can release their resources."""
        dropped = [t for t in self.inflight if pred(t)]
        self.inflight = [t for t in self.inflight if not pred(t)]
        return dropped

    def advance(self, hook) -> Tuple[List[TierTransfer], List[TierTransfer]]:
        completed: List[TierTransfer] = []
        failed: List[TierTransfer] = []
        keep: List[TierTransfer] = []
        for t in self.inflight:
            t.age += 1
            if t.age > self.cfg.timeout_ticks:
                t.failure = "timeout"
                self.timeouts += 1
                failed.append(t)
                continue
            if t.backoff > 0:
                t.backoff -= 1
                if t.backoff == 0:
                    # next attempt begins at the link speed of *this* tick
                    t.eta = max(1, math.ceil(self.cfg.xfer_ticks
                                             * hook.slow()))
                keep.append(t)
                continue
            t.eta -= 1
            if t.eta > 0:
                keep.append(t)
                continue
            # the attempt lands this tick — unless the link drops it
            if hook.drop():
                t.retries += 1
                self.retries += 1
                if t.retries > self.cfg.max_retries:
                    t.failure = "retries exhausted"
                    failed.append(t)
                    continue
                t.backoff = 2 ** (t.retries - 1)
                keep.append(t)
                continue
            completed.append(t)
        self.inflight = keep
        return completed, failed


def trim_pages(payload: Any, n: int) -> Any:
    """Keep the first ``n`` pages (axis 1) of a payload, contiguous."""
    return _tree_map(lambda a: a[:, :n].contiguous(), payload)


def pad_pages(payload: Any, k: int) -> Any:
    """Zero-pad a payload to ``k`` pages (axis 1). The reference pads
    every transfer to one static width for its compile-once scatter; the
    port installs the pages it has (its scatter runs eagerly), so the
    engine does not pad."""
    def _pad(a):
        if a.shape[1] == k:
            return a
        pad = torch.zeros((a.shape[0], k - a.shape[1]) + tuple(a.shape[2:]),
                          dtype=a.dtype)
        return torch.cat([a, pad], dim=1)
    return _tree_map(_pad, payload)


def slice_page(payload: Any, j: int) -> Any:
    """Page ``j`` as its own single-page payload (axis 1 kept)."""
    return _tree_map(lambda a: a[:, j:j + 1].contiguous(), payload)


def concat_pages(payloads: List[Any]) -> Any:
    """Stitch single-page payloads back into one multi-page payload."""
    first = payloads[0]
    if isinstance(first, dict):
        return {k: concat_pages([p[k] for p in payloads]) for k in first}
    return torch.cat(payloads, dim=1)
