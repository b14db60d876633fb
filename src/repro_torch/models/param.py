"""Parameter-spec system (port of ``repro.models.param``).

Every model describes its parameters as a nested dict of ``ParamSpec``
(shape, dtype, logical axes, initializer) with the reference's key names,
so a JAX parameter tree copies across key for key (``bridge.py``).
``init_params`` materializes the tree on a device from a seed with the
reference's distributions (normal: std 0.02·scale; fan_in: scale/√fan;
zeros; ones). It does not reproduce ``jax.random``'s bits: tests that
compare the packages copy the JAX weights instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.fp8 import Fp8Experts, Fp8Weight
from repro_torch.device import resolve_device, torch_dtype

# Leaves larger than this are drawn slice by slice along their leading
# axes, so the fp32 draw never needs a full-size temporary (the MoE
# expert stacks are ~11 B parameters at published widths).
_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: Any
    axes: Tuple[Optional[str], ...]
    init: str = "normal"     # normal | zeros | ones | fan_in
    scale: float = 1.0       # stddev multiplier for normal inits

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    def std(self) -> float:
        if self.init == "normal":
            return 0.02 * self.scale
        if self.init == "fan_in":
            # fan-in = product of all dims except the last output dim,
            # excluding a leading stacked "layers" axis (reference rule)
            fan = max(1, math.prod(self.shape[:-1]) // (
                self.shape[0] if self.axes and self.axes[0] == "layers"
                and len(self.shape) > 1 else 1))
            return self.scale / math.sqrt(fan)
        raise ValueError(self.init)

    def materialize(self, gen: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        dt = torch_dtype(self.dtype)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        std = self.std()
        out = torch.empty(self.shape, dtype=dt, device=device)
        # draw in fp32 (the reference's draw dtype), cast per row block
        flat = out.view(-1, self.shape[-1])
        per = max(1, _CHUNK_BYTES // (4 * self.shape[-1]))
        for i in range(0, flat.shape[0], per):
            blk = flat[i:i + per]
            blk.copy_(torch.randn(blk.shape, generator=gen, device=device,
                                  dtype=torch.float32) * std)
        return out


def init_params(spec_tree, seed: int = 0, device=None):
    """Materialize every ParamSpec on ``device`` (default ``cuda``) from
    ``seed``: one ``torch.Generator`` on that device per leaf, seeded from
    (seed, the leaf's index in sorted-key order)."""
    dev = resolve_device(device)
    index = [0]

    def walk(tree):
        if not isinstance(tree, ParamSpec):
            return {k: walk(tree[k]) for k in sorted(tree)}
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 1_000_003 + index[0])
        index[0] += 1
        return tree.materialize(gen, dev)

    return walk(spec_tree)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (tensors, Fp8Weights, Fp8Experts):
    views, so a cache slice written in place writes the stacked cache."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    if isinstance(tree, (Fp8Weight, Fp8Experts)):
        return tree.layer(i)
    return tree[i]
