"""Mesh helpers of the launchers — the port's copy of the part of
``repro.launch.mesh`` that training needs: the elastic re-mesh after a
node failure (paper §6.1). The launchers (``launch/serve.py``,
``launch/train.py``) build their meshes over spawned ranks themselves.
"""
from __future__ import annotations

import itertools

from repro_torch.parallel.context import Mesh, _rank_of

DP_AXES = ("pod", "data")


def dp_axes_for(mesh: Mesh):
    return tuple(a for a in DP_AXES if a in mesh.axis_names)


def survivor_mesh(mesh: Mesh) -> Mesh:
    """Elastic re-mesh after a node failure: halve the first
    data-parallel axis of size > 1 ("pod" before "data"), keeping the
    model/EP axis whole so that expert shards and weight blocks stay
    divisible. The survivors are the positions in the first half of that
    axis, in the new mesh's row-major order; every rank of the default
    group must call this (``Mesh.create`` makes each axis line's group on
    every rank), and a dropped rank gets a mesh without a position
    (``rank`` None). Returns ``mesh`` itself when no axis can shrink (a
    restart in place)."""
    names = list(mesh.axis_names)
    shape = [mesh.shape[a] for a in names]
    for i, a in enumerate(names):
        if a in DP_AXES and shape[i] > 1:
            new = list(shape)
            new[i] //= 2
            survivors = [mesh.ranks[_rank_of(c, shape)]
                         for c in itertools.product(*map(range, new))]
            return Mesh.create(tuple(new), tuple(names), ranks=survivors)
    return mesh
