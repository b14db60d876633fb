"""Serve-side fault injection — port of ``repro.serve.fault``.

The gateway's health machinery (registry heartbeats, circuit breakers,
retry/re-dispatch — ``serve/gateway.py``) is only trustworthy if it is
*exercised*: this module injects the replica-level failure modes the
paper's §6.1 reliability discussion worries about, translated to the
serving tier. Faults are scheduled on the gateway's tick clock with the
shared ``faultspec.py`` grammar (``kind[:replica]``):

* ``crash:<r>``       — replica ``r`` dies: every interaction raises
  ``ReplicaCrash`` and its heartbeats stop. Permanent (a dead engine
  process does not come back; a real deployment re-registers a fresh one).
* ``hang:<r>``        — replica stops making progress *and* stops
  heartbeating, but calls don't fail fast — the failure mode heartbeat
  SUSPECT→DEAD escalation exists for. Permanent until ``revive``.
* ``slow:<r>``        — replica's step wall-time is scaled by
  ``slow_factor`` for ``slow_ticks`` ticks (a straggler, not a corpse:
  heartbeats continue; the router should steer around it via load).
* ``flaky-admit:<r>`` — replica rejects admissions (raises
  ``AdmissionError``) for ``flaky_ticks`` ticks — consecutive failures
  that must trip the circuit breaker, then succeed on a half-open probe
  once the flakiness passes.
* ``pcie_slow:<r>``   — the replica's KV-tier transfer link degrades:
  spill/fetch ETAs are stretched by ``pcie_slow_factor`` for
  ``pcie_ticks`` ticks (the §4.5 PCIe contention scenario).
* ``pcie_drop:<r>``   — the link goes lossy: transfer completion attempts
  fail for ``pcie_ticks`` ticks, exercising the bounded retry/backoff and
  timeout-escalation path.
* ``tier_full``       — the host page tier reports no capacity for
  ``pcie_ticks`` ticks: spills are refused and preemption falls back to
  the evict-and-requeue ladder rung.

The injector is pure bookkeeping — the *gateway* consults it at each
interaction point (heartbeat, admit, step) and fails accordingly, so the
failure surfaces exactly where a real fault would: in the caller. Tier
faults reach a replica's engine through :class:`TierFaultAdapter`, the
engine-facing hook ``serve/tier.py``'s transfer clock consults.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set

from repro_torch import faultspec


class ReplicaCrash(RuntimeError):
    """Simulated replica death (process gone / device lost)."""


@dataclasses.dataclass
class ServeFaultInjector:
    """Deterministic tick->fault schedule for a gateway's replica pool.

    ``schedule`` maps a gateway tick to a ``kind[:replica]`` spec
    (validated against ``faultspec.SERVE_KINDS`` at construction; an
    unaddressed spec targets replica 0, matching the train injector).
    Drive ``advance(tick)`` once per gateway tick, then query the
    predicates.
    """

    schedule: Dict[int, str]
    slow_factor: float = 10.0
    slow_ticks: int = 8          # how long a slow:<r> straggler persists
    flaky_ticks: int = 4         # how long flaky-admit:<r> rejects
    pcie_slow_factor: float = 4.0  # ETA stretch while pcie_slow is active
    pcie_ticks: int = 6          # window of pcie_slow / pcie_drop /
                                 # tier_full faults

    def __post_init__(self):
        for tick, spec in self.schedule.items():
            if not isinstance(tick, int) or tick < 0:
                raise ValueError(f"schedule tick {tick!r} must be a "
                                 "non-negative int")
            faultspec.parse_spec(spec, faultspec.SERVE_KINDS)
        self._crashed: Set[int] = set()
        self._hung: Set[int] = set()
        self._slow_until: Dict[int, int] = {}
        self._flaky_until: Dict[int, int] = {}
        self._pcie_slow_until: Dict[int, int] = {}
        self._pcie_drop_until: Dict[int, int] = {}
        self._tier_full_until: Dict[int, int] = {}
        self._fired: Set[int] = set()
        self.events = []          # [(tick, spec)] — what actually fired

    def advance(self, tick: int) -> Optional[faultspec.FaultSpec]:
        """Fire the schedule entry for ``tick`` (once); returns the parsed
        spec that fired, or None."""
        spec = self.schedule.get(tick)
        if spec is None or tick in self._fired:
            return None
        self._fired.add(tick)
        fs = faultspec.parse_spec(spec, faultspec.SERVE_KINDS)
        r = fs.replica if fs.replica is not None else 0
        if fs.kind == "crash":
            self._crashed.add(r)
        elif fs.kind == "hang":
            self._hung.add(r)
        elif fs.kind == "slow":
            self._slow_until[r] = tick + self.slow_ticks
        elif fs.kind == "flaky-admit":
            self._flaky_until[r] = tick + self.flaky_ticks
        elif fs.kind == "pcie_slow":
            self._pcie_slow_until[r] = tick + self.pcie_ticks
        elif fs.kind == "pcie_drop":
            self._pcie_drop_until[r] = tick + self.pcie_ticks
        elif fs.kind == "tier_full":
            self._tier_full_until[r] = tick + self.pcie_ticks
        self.events.append((tick, str(fs)))
        return fs

    # -- predicates the gateway consults at each interaction point --------
    def crashed(self, replica: int) -> bool:
        return replica in self._crashed

    def hung(self, replica: int) -> bool:
        return replica in self._hung

    def heartbeats(self, replica: int) -> bool:
        """Crashed and hung replicas stop heartbeating; slow/flaky ones
        keep announcing themselves (that is what makes them insidious)."""
        return not (self.crashed(replica) or self.hung(replica))

    def slow_multiplier(self, replica: int, tick: int) -> float:
        """Step wall-time multiplier for ``replica`` at ``tick``."""
        return (self.slow_factor
                if tick < self._slow_until.get(replica, -1) else 1.0)

    def admit_fails(self, replica: int, tick: int) -> bool:
        return tick < self._flaky_until.get(replica, -1)

    def check_alive(self, replica: int) -> None:
        """Raise ``ReplicaCrash`` if ``replica`` has crashed — called by
        the gateway before any interaction with the replica's engine, so
        the crash surfaces where a dead process would: in the caller."""
        if self.crashed(replica):
            raise ReplicaCrash(f"replica {replica} crashed (injected)")

    def revive(self, replica: int) -> None:
        """Clear a hang (operator intervention / the process un-wedged).
        Crashes are permanent by design — a dead engine re-registers as a
        new replica instead."""
        self._hung.discard(replica)

    # -- tier-transfer predicates (consulted via TierFaultAdapter) --------
    def pcie_slow_multiplier(self, replica: int, tick: int) -> float:
        """Transfer-ETA stretch for ``replica``'s tier link at ``tick``."""
        return (self.pcie_slow_factor
                if tick < self._pcie_slow_until.get(replica, -1) else 1.0)

    def pcie_drops(self, replica: int, tick: int) -> bool:
        """Whether a transfer completion attempt at ``tick`` is dropped."""
        return tick < self._pcie_drop_until.get(replica, -1)

    def tier_full(self, replica: int, tick: int) -> bool:
        """Whether the host tier refuses reservations at ``tick``."""
        return tick < self._tier_full_until.get(replica, -1)


class TierFaultAdapter:
    """Engine-facing view of one replica's tier-fault state.

    ``ServeEngine`` and the transfer clock query faults with no-argument
    predicates (they know nothing about replicas or the gateway clock);
    this adapter binds an injector to a replica id and a clock. Standalone
    engines (no gateway) pass ``clock=None`` and the adapter keeps its own
    tick counter, advanced by the engine calling :meth:`on_tick` at the
    top of each ``step()`` — ``ServeFaultInjector.advance`` is idempotent
    per tick, so gateway-driven and engine-driven advancement compose.
    """

    def __init__(self, injector: ServeFaultInjector, replica: int = 0,
                 clock=None):
        self.injector = injector
        self.replica = replica
        self._clock = clock
        self._tick = -1

    def _now(self) -> int:
        return self._clock() if self._clock is not None else self._tick

    def on_tick(self) -> None:
        if self._clock is None:
            self._tick += 1
            self.injector.advance(self._tick)

    def drop(self) -> bool:
        return self.injector.pcie_drops(self.replica, self._now())

    def slow(self) -> float:
        return self.injector.pcie_slow_multiplier(self.replica, self._now())

    def full(self) -> bool:
        return self.injector.tier_full(self.replica, self._now())
