"""Fault tolerance & straggler mitigation (paper §6.1) — port of
``repro.train.fault``. ``replica_step_times`` (per-shard completion times
on a device mesh) is meshed and waits for ROADMAP.md, A.8.

The paper lists interconnect failures, node crashes and silent data
corruption as the dominant large-scale risks. This module provides the
trainer-side machinery, exercised in tests via injection:

* ``FailureInjector``   — deterministic fault schedule (step -> kind).
* ``StragglerMonitor``  — per-step EWMA timing; replicas slower than
  ``threshold`` x median are flagged; policy: drop their microbatch for
  the step and rescale the gradient (bounded staleness), or just record.
* ``SDCGuard``          — cross-replica parameter checksums every N steps
  (DP replicas must be bit-identical); mismatch -> restore-from-checkpoint
  signal. This turns the paper's "application-level heuristics" remark
  into a concrete mechanism.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch import faultspec


class NodeFailure(RuntimeError):
    """Simulated node/interconnect failure."""


@dataclasses.dataclass
class FailureInjector:
    schedule: Dict[int, str]          # step -> kind ("node", "net", "sdc",
                                      #               "slow:<replica>")
    fired: set = dataclasses.field(default_factory=set)
    slow_factor: float = 10.0         # injected slowdown multiplier

    def check(self, step: int) -> None:
        kind = self.schedule.get(step)
        if kind and step not in self.fired and not kind.startswith("slow"):
            self.fired.add(step)
            if kind in ("node", "net"):
                raise NodeFailure(f"injected {kind} failure at step {step}")

    def corrupts(self, step: int) -> bool:
        return self.schedule.get(step) == "sdc" and step not in self.fired

    def slow_replica(self, step: int) -> Optional[int]:
        """Replica index to slow down at ``step`` (None = no injection).
        The trainer scales that replica's *measured* step time by
        ``slow_factor`` — perturbing the real measurement path rather
        than fabricating a timing vector."""
        kind = self.schedule.get(step)
        if kind and kind.startswith("slow"):
            fs = faultspec.parse_spec(kind, faultspec.TRAIN_KINDS)
            return fs.replica if fs.replica is not None else 0
        return None


class StragglerMonitor:
    def __init__(self, n_replicas: int, alpha: float = 0.2,
                 threshold: float = 1.5):
        self.ewma = [0.0] * n_replicas
        self.alpha = alpha
        self.threshold = threshold
        self.events: List[dict] = []

    def observe(self, step: int, times: List[float]) -> List[int]:
        """Feed per-replica step times; returns indices flagged slow."""
        for i, t in enumerate(times):
            self.ewma[i] = (t if self.ewma[i] == 0.0
                            else (1 - self.alpha) * self.ewma[i]
                            + self.alpha * t)
        # lower median: with few replicas the upper median IS the
        # straggler, which would mask it from its own comparison
        med = sorted(self.ewma)[(len(self.ewma) - 1) // 2]
        slow = [i for i, e in enumerate(self.ewma)
                if med > 0 and e > self.threshold * med]
        if slow:
            self.events.append({"step": step, "slow": slow,
                                "ewma": list(self.ewma)})
        return slow


class SDCGuard:
    """Tracks the parameter checksum; in multi-host deployment each DP
    replica computes it independently and they are compared (replicas are
    bit-identical by construction). A change without an optimizer step, or
    cross-replica disagreement, flags corruption."""

    def __init__(self):
        self.last: Optional[int] = None
        self.alarms: List[int] = []

    def check(self, step: int, checksums: List[int]) -> bool:
        ok = all(c == checksums[0] for c in checksums)
        if not ok:
            self.alarms.append(step)
        self.last = checksums[0]
        return ok
