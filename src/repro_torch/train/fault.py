"""Fault tolerance & straggler mitigation (paper §6.1) — port of
``repro.train.fault``, with ``replica_step_times`` (each rank's step
time, gathered over the mesh: one entry per data replica).

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
import time
from typing import Dict, List, Optional

import torch

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


def replica_step_times(out: torch.Tensor, mesh, dp_axes, t0: float
                       ) -> List[float]:
    """Per-replica step times under explicit SPMD (the reference's
    ``replica_step_times``). Each rank times its own step to its
    completion (``out``, any output of the step: on the card a
    synchronize of its device, on the CPU the wall clock), the ranks
    gather their times over every axis of the mesh, and a data replica's
    time is the max over its ranks on the other axes. Returns one entry
    per data replica, the same on every rank.

    As in the reference this measures completion skew: collectives inside
    the step (the gradient norm, the EP all-to-alls) hold the replicas
    together, so a slow replica lengthens every reading; the trainer's
    injector perturbs these readings (``slow:<r>``) to drive the
    monitor."""
    from repro_torch.parallel import collectives as coll
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    t = torch.tensor([time.perf_counter() - t0], dtype=torch.float64)
    names = list(mesh.axis_names)
    for a in reversed(names):                 # -> the mesh's shape
        t = (coll.all_gather(t[None], mesh.groups[a])
             if mesh.shape[a] > 1 else t[None])
    t = t.reshape([mesh.shape[a] for a in names])
    dp = [names.index(a) for a in dp_axes]
    t = t.permute(dp + [i for i in range(len(names)) if i not in dp])
    n_rep = 1
    for a in dp_axes:
        n_rep *= mesh.shape[a]
    return t.reshape(n_rep, -1).max(dim=1).values.tolist()


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
