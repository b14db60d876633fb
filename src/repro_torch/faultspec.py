"""Fault-injection spec parsing — a copy of ``repro.faultspec`` (the port
imports nothing of the reference package), shared by the serve injector.

Both fault harnesses (``train/fault.py`` exercising the trainer's §6.1
machinery, ``serve/fault.py`` exercising the gateway's health/retry
machinery) schedule faults as compact strings — ``"slow:3"``,
``"crash:0"``, ``"node"`` — mapping a step/tick to a fault kind plus an
optional replica index. The ``kind[:replica]`` grammar lives here so the
two injectors (and the launchers' ``--chaos`` flags) cannot drift: a spec
either parses identically everywhere or raises ``ValueError`` loudly.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Optional

# Kinds each harness accepts. Train faults address the whole job ("node",
# "net", "sdc") or a DP replica ("slow:<r>"); serve faults always address
# one replica of the gateway's pool. The ``pcie_*``/``tier_full`` kinds
# target a replica's KV-tier transfer path: a degraded PCIe
# link (slow), a lossy one (drop), and an exhausted host page tier.
TRAIN_KINDS: FrozenSet[str] = frozenset({"node", "net", "sdc", "slow"})
SERVE_KINDS: FrozenSet[str] = frozenset(
    {"crash", "hang", "slow", "flaky-admit",
     "pcie_slow", "pcie_drop", "tier_full"})


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed fault: a kind plus the replica it targets (None = the
    whole job / unspecified, which injectors default as they see fit)."""

    kind: str
    replica: Optional[int] = None

    def __str__(self) -> str:
        return (self.kind if self.replica is None
                else f"{self.kind}:{self.replica}")


def parse_spec(spec: str, kinds: Optional[FrozenSet[str]] = None
               ) -> FaultSpec:
    """Parse ``"kind"`` or ``"kind:<replica>"`` into a ``FaultSpec``.

    ``kinds`` restricts the accepted kind vocabulary (``TRAIN_KINDS`` /
    ``SERVE_KINDS``); None accepts any non-empty kind. Malformed specs —
    empty kind, non-integer or negative replica, stray colons — raise
    ``ValueError`` rather than silently injecting nothing.
    """
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"fault spec must be a non-empty string, got "
                         f"{spec!r}")
    parts = spec.split(":")
    if len(parts) > 2 or not parts[0]:
        raise ValueError(f"fault spec {spec!r} is not 'kind' or "
                         "'kind:<replica>'")
    kind = parts[0]
    if kinds is not None and kind not in kinds:
        raise ValueError(f"unknown fault kind {kind!r} in {spec!r} "
                         f"(expected one of {sorted(kinds)})")
    replica: Optional[int] = None
    if len(parts) == 2:
        try:
            replica = int(parts[1])
        except ValueError:
            raise ValueError(f"fault spec {spec!r}: replica {parts[1]!r} "
                             "is not an integer") from None
        if replica < 0:
            raise ValueError(f"fault spec {spec!r}: replica index must be "
                             ">= 0")
    return FaultSpec(kind, replica)


def parse_schedule(text: str, kinds: Optional[FrozenSet[str]] = None
                   ) -> dict:
    """Parse a CLI chaos schedule ``"tick=spec[,tick=spec...]"`` into
    ``{tick: spec_string}`` (specs validated, stored as strings so the
    schedule stays printable/serializable). Used by ``--chaos`` flags."""
    schedule = {}
    for item in text.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"chaos schedule entry {item!r} is not "
                             "'tick=kind[:replica]'")
        at, spec = item.split("=", 1)
        try:
            tick = int(at)
        except ValueError:
            raise ValueError(f"chaos schedule entry {item!r}: tick "
                             f"{at!r} is not an integer") from None
        parse_spec(spec, kinds)      # validate; raises on junk
        schedule[tick] = spec
    return schedule
