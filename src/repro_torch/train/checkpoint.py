"""Atomic checkpointing with newest-intact restore (paper §6.1
robustness) — port of ``repro.train.checkpoint``, same contract.

Layout per step::

    <dir>/step_<n>.tmp/...   (written first)
    <dir>/step_<n>/
        arrays.npz           flat {path -> np.ndarray} of the whole tree
        MANIFEST.json        step, flat paths, crc32 per array, dtypes,
                             extras

Atomicity: write into ``.tmp`` then ``os.rename`` (atomic on POSIX).
Keep-last-k garbage collection. CRC validation on load guards against
storage-level corruption.

An auto-restore (``step=None``) walks the checkpoints newest-first and
loads the newest **intact** one: a step with a corrupt array, a truncated
manifest or a missing file is warned about and skipped. An explicit
``step=`` stays strict: corruption there raises. Malformed ``step_*``
directory names are ignored.

bf16 arrays are stored as their uint16 bits, their dtype in the manifest
(numpy has no bf16 without ``ml_dtypes``). Arrays are stored whole
(logical), as the reference's. Under a mesh (``save(..., mesh=,
pspecs=)``) every rank gathers each leaf's cuts over the mesh, one leaf
at a time, and the rank at mesh position 0 writes them (the ``.tmp``
rename stays the one atomic step); the others wait on the mesh's
barrier. ``restore(..., mesh=, pspecs=)`` cuts each rank's region of
every logical array by the placements of the mesh it is given, which
may be another mesh than the one that saved (the elastic re-shard).

A tree is nested dicts, NamedTuples (the optimizer state: their field
names are path parts) and tensors; restore rebuilds the structure of the
``tree_like`` it is given (its leaves only contribute structure: meta
tensors will do).
"""
from __future__ import annotations

import json
import os
import shutil
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _items(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _items(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for k in tree._fields:
            out += _items(getattr(tree, k), f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _rebuild(tree, leaf_fn, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_fn, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, k), leaf_fn,
                                     f"{prefix}{k}/") for k in tree._fields))
    return leaf_fn(prefix[:-1], tree)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _logical(leaf: torch.Tensor, pspec, mesh) -> torch.Tensor:
    """A rank's cut of a leaf gathered over the mesh into the whole
    (every rank of the mesh calls it, leaf by leaf in one order). A
    dimension cut over the data pair ``("pod", "data")`` is gathered over
    the data plane, in pod-major order."""
    from repro_torch.parallel import collectives as coll
    for d, e in enumerate(pspec):
        g = mesh.group_of(e)
        if g is not None:
            leaf = coll.all_gather(leaf, g, dim=d)
    return leaf


def mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for every other: a barrier on each
    axis line, the last axis first (after it, each line of the first axis
    holds ranks that have all waited for their own line)."""
    import torch.distributed as dist
    for a in reversed(mesh.axis_names):
        if mesh.shape[a] > 1:
            dist.barrier(group=mesh.groups[a])


def save(directory: str, step: int, tree, extras: Optional[dict] = None,
         keep: int = 3, mesh=None, pspecs=None) -> str:
    """Write ``tree`` as step ``step`` (atomically), keeping the newest
    ``keep`` steps. With ``mesh`` and ``pspecs`` (a tree of
    PartitionSpecs of ``tree``'s structure) the tree is a rank's shards:
    every rank of the mesh calls it; the logical arrays are gathered and
    the rank at mesh position 0 writes them."""
    writer = mesh is None or mesh.rank == 0
    final = os.path.join(directory, f"step_{step:08d}")
    flat, dtypes = {}, {}
    specs = None if pspecs is None else dict(_items(pspecs))
    for k, leaf in _items(tree):
        t = torch.as_tensor(leaf)
        if mesh is not None:
            t = _logical(t, specs[k], mesh)
        if writer:
            flat[k], dtypes[k] = _to_numpy(t)
    if not writer:
        mesh_barrier(mesh)
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "crc": {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
                for k, v in flat.items()},
        "dtypes": dtypes,
        "extras": extras or {},
    }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    if mesh is not None:
        mesh_barrier(mesh)
    return final


def _step_ids(directory: str) -> List[int]:
    """Completed step numbers on disk, tolerant of operator debris: a
    ``step_foo`` or truncated ``step_`` directory is skipped, not fatal."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        try:
            out.append(int(d.split("_")[1]))
        except (IndexError, ValueError):
            continue
    return sorted(set(out))


def latest_step(directory: str) -> Optional[int]:
    steps = _step_ids(directory)
    return steps[-1] if steps else None


def _load_verified(directory: str, step: int) -> Tuple[dict, Dict[str, Any]]:
    """Open one checkpoint and verify it end to end (manifest parses,
    every array present, every CRC matches). Raises on any defect."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k in manifest["keys"]:
            if k not in data:
                raise IOError(f"checkpoint step {step} missing array {k}")
            a = data[k]
            crc = zlib.crc32(np.ascontiguousarray(a).tobytes())
            if crc != manifest["crc"][k]:
                raise IOError(f"checkpoint corruption detected in {k} "
                              f"(crc {crc} != {manifest['crc'][k]})")
            out[k] = a
    return manifest, out


def restore(directory: str, tree_like, step: Optional[int] = None,
            device=None, pspecs=None, mesh=None) -> Tuple[Any, dict]:
    """Restore into the structure of ``tree_like`` on ``device`` (default:
    the CPU). ``step=None`` loads the newest intact checkpoint, warning
    about each damaged one it skips; an explicit ``step=`` raises on any
    defect. With ``pspecs`` (a tree of PartitionSpecs of ``tree_like``'s
    structure) and a live ``mesh`` each leaf is this rank's region of the
    logical array (``sharding.region_of``), bit for bit. Returns ``(tree,
    extras)``."""
    if step is None:
        candidates = _step_ids(directory)
        if not candidates:
            raise IOError(f"no checkpoints in {directory}")
        manifest = data = None
        for s in reversed(candidates):
            try:
                manifest, data = _load_verified(directory, s)
                break
            except Exception as e:          # noqa: BLE001 — any defect
                # (bad zip, truncated json, missing member, CRC) means
                # this step is unusable; the walk continues backwards
                warnings.warn(
                    f"skipping damaged checkpoint step_{s:08d}: {e}")
        if manifest is None:
            raise IOError(f"no intact checkpoint in {directory} "
                          f"(tried steps {candidates})")
    else:
        manifest, data = _load_verified(directory, step)

    specs = None if pspecs is None else dict(_items(pspecs))

    def leaf(key, _):
        a = data[key]
        if specs is not None:
            from repro_torch.parallel.sharding import region_of
            a = a[tuple(slice(*r) for r in region_of(a.shape, specs[key],
                                                     mesh))]
        return _from_numpy(a, manifest["dtypes"][key]).to(device or "cpu")

    return _rebuild(tree_like, leaf), manifest["extras"]


def _gc(directory: str, keep: int) -> None:
    for s in _step_ids(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
