"""MTP self-speculative decoding analysis (paper §2.3.3) — a copy of
``repro.serve.speculative`` (no JAX in it), so ``measured`` reads the
port's engine.

The ServeEngine measures the functional quantity — the draft **acceptance
rate** (paper: 80–90 % for the second token). This module converts it into
the serving speedup the paper reports (~1.8x TPS at 80–90 %):

With one MTP module, each verify step emits 1 + accept ∈ {1, 2} tokens for
one main-model pass (the draft rides the same batch), so

    expected tokens/step = 1 + p_accept
    TPS multiplier       = (1 + p_accept) / (1 + overhead)

where ``overhead`` is the MTP module's relative cost (1 extra layer of 61
for V3 ≈ 1.6 %, plus one extra unembed). The paper's observed 1.8x at
p≈0.85 corresponds to overhead ≈ 3 %.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SpecDecodeModel:
    acceptance: float           # measured draft acceptance rate
    mtp_layers: int = 1
    model_layers: int = 61
    unembed_overhead: float = 0.015

    @property
    def overhead(self) -> float:
        return self.mtp_layers / self.model_layers + self.unembed_overhead

    @property
    def tokens_per_step(self) -> float:
        return 1.0 + self.acceptance

    @property
    def tps_multiplier(self) -> float:
        return self.tokens_per_step / (1.0 + self.overhead)


def paper_claim() -> SpecDecodeModel:
    """The paper's reported operating point: 80–90 % acceptance -> 1.8x."""
    return SpecDecodeModel(acceptance=0.85)


def measured(engine) -> SpecDecodeModel:
    """Build the speedup model from a ``ServeEngine`` run's on-device
    acceptance counters (the fused ``decode_loop`` counts draft hits per
    chunk; ``engine.acceptance_rate()`` aggregates them host-side)."""
    cfg = engine.cfg
    return SpecDecodeModel(
        acceptance=engine.acceptance_rate(),
        mtp_layers=cfg.mtp.num_modules if cfg.mtp else 1,
        model_layers=cfg.num_layers)
