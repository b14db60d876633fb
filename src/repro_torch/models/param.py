"""Parameter-spec system (port of ``repro.models.param``).

Every model describes its parameters as a nested dict of ``ParamSpec``
(shape, dtype, logical axes, initializer) with the reference's key names,
so a JAX parameter tree copies across key for key (``bridge.py``).
``init_params`` materializes the tree on a device from a seed with the
reference's distributions (normal: std 0.02·scale; fan_in: scale/√fan;
zeros; ones). It does not reproduce ``jax.random``'s bits: tests that
compare the packages copy the JAX weights instead. With a ``placement``
(a mesh rank's PartitionSpecs, ``parallel/sharding``) it keeps only that
rank's slice of each leaf: every leaf is still drawn whole, block by block
from its own generator, so the slices of all ranks tile the tree one
device would draw from the same seed.
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

    def materialize(self, gen: torch.Generator, device: torch.device,
                    region: Optional[Tuple[Tuple[int, int], ...]] = None
                    ) -> torch.Tensor:
        """The leaf, or only its ``region`` (a ``(start, stop)`` per axis)
        of the same draw."""
        dt = torch_dtype(self.dtype)
        region = region or tuple((0, n) for n in self.shape)
        local = tuple(b - a for a, b in region)
        if self.init == "zeros":
            return torch.zeros(local, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(local, dtype=dt, device=device)
        std = self.std()
        out = torch.empty(local, dtype=dt, device=device)
        # draw in fp32 (the reference's draw dtype) per block of rows of the
        # whole leaf, cast, and keep the rows and columns of the region
        last = self.shape[-1]
        lead = self.shape[:-1]
        rows = math.prod(lead)
        c0, c1 = region[-1]
        oflat = out.view(-1, c1 - c0)
        whole_rows = all(r == (0, n) for r, n in zip(region, lead))
        per = max(1, _CHUNK_BYTES // (4 * last))
        for i in range(0, rows, per):
            n = min(per, rows - i)
            blk = torch.randn((n, last), generator=gen, device=device,
                              dtype=torch.float32) * std
            if whole_rows:
                oflat[i:i + n] = blk[:, c0:c1]
                continue
            r = torch.arange(i, i + n, device=device)
            inside = torch.ones(n, dtype=torch.bool, device=device)
            lrow = torch.zeros(n, dtype=torch.int64, device=device)
            stride = 1
            for d in reversed(range(len(lead))):
                c = r % lead[d]
                r = r // lead[d]
                a, b = region[d]
                inside &= (c >= a) & (c < b)
                lrow += (c - a) * stride
                stride *= b - a
            sel = inside.nonzero()[:, 0]
            oflat[lrow[sel]] = blk[sel, c0:c1].to(dt)
        return out


def init_params(spec_tree, seed: int = 0, device=None, placement=None):
    """Materialize every ParamSpec on ``device`` (default ``cuda``) from
    ``seed``: one ``torch.Generator`` on that device per leaf, seeded from
    (seed, the leaf's index in sorted-key order). ``placement``: ``(pspecs,
    mesh)`` of a live mesh rank; each leaf is then this rank's slice (its
    peak is its shard plus one drawn block of at most 1 GB)."""
    dev = resolve_device(device)
    index = [0]

    def walk(tree, pspecs):
        if not isinstance(tree, ParamSpec):
            return {k: walk(tree[k], None if pspecs is None else pspecs[k])
                    for k in sorted(tree)}
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 1_000_003 + index[0])
        index[0] += 1
        region = None
        if pspecs is not None:
            from repro_torch.parallel.sharding import region_of
            region = region_of(tree.shape, pspecs, placement[1])
        return tree.materialize(gen, dev, region)

    return walk(spec_tree, None if placement is None else placement[0])


def param_structs(spec_tree):
    """The tree of a ParamSpec tree as ``meta`` tensors of its shapes and
    dtypes (the reference's ``param_structs``: nothing allocated)."""
    if isinstance(spec_tree, ParamSpec):
        return torch.empty(spec_tree.shape,
                           dtype=torch_dtype(spec_tree.dtype), device="meta")
    return {k: param_structs(v) for k, v in spec_tree.items()}


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (tensors, Fp8Weights, Fp8Experts):
    views, so a cache slice written in place writes the stacked cache."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    if isinstance(tree, (Fp8Weight, Fp8Experts)):
        return tree.layer(i)
    return tree[i]
