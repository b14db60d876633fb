"""Mesh helpers of the launchers — the port of ``repro.launch.mesh``: the
production meshes of the dry run and the elastic re-mesh after a node
failure (paper §6.1). The launchers (``launch/serve.py``,
``launch/train.py``) build their meshes over spawned ranks themselves.

Single pod: (16, 16) = 256 ranks, axes (data, model). Multi-pod:
(2, 16, 16) = 512 ranks, axes (pod, data, model). Defined as functions, so
importing this module touches no process group.
"""
from __future__ import annotations

import itertools
import math

from repro_torch.parallel.context import DATA_AXES, Mesh, _rank_of, data_axes


def production_shape(multi_pod: bool = False):
    """The reference's production mesh: ``(shape, axis names)``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh as a port :class:`Mesh`: inside an initialized
    world of its size (the dry run's fake one) with every axis line's
    group (``Mesh.create``, a collective call every rank makes), else
    ``Mesh.abstract`` (shapes only)."""
    import torch.distributed as dist
    shape, axes = production_shape(multi_pod)
    if dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        return Mesh.create(shape, axes)
    return Mesh.abstract(shape, axes)


def dp_axes_for(mesh: Mesh):
    return data_axes(mesh.axis_names)


def survivor_mesh(mesh: Mesh) -> Mesh:
    """Elastic re-mesh after a node failure: halve the first
    data-parallel axis of size > 1 ("pod" before "data"), keeping the
    model/EP axis whole so that expert shards and weight blocks stay
    divisible. The survivors are the positions in the first half of that
    axis, in the new mesh's row-major order; every rank of the default
    group must call this (``Mesh.create`` makes each axis line's group,
    and on a three-axis mesh each data plane's, on every rank), and a
    dropped rank gets a mesh without a position (``rank`` None). Returns
    ``mesh`` itself when no axis can shrink (a restart in place)."""
    names = list(mesh.axis_names)
    shape = [mesh.shape[a] for a in names]
    for i, a in enumerate(names):
        if a in DATA_AXES and shape[i] > 1:
            new = list(shape)
            new[i] //= 2
            survivors = [mesh.ranks[_rank_of(c, shape)]
                         for c in itertools.product(*map(range, new))]
            return Mesh.create(tuple(new), tuple(names), ranks=survivors)
    return mesh
