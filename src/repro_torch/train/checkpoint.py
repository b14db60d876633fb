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
(logical), as the reference's; restoring onto another mesh (the elastic
re-shard) waits for ROADMAP.md, A.8.

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


def save(directory: str, step: int, tree, extras: Optional[dict] = None,
         keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat, dtypes = {}, {}
    for k, leaf in _items(tree):
        flat[k], dtypes[k] = _to_numpy(torch.as_tensor(leaf))
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
            device=None) -> Tuple[Any, dict]:
    """Restore into the structure of ``tree_like`` on ``device`` (default:
    the CPU). ``step=None`` loads the newest intact checkpoint, warning
    about each damaged one it skips; an explicit ``step=`` raises on any
    defect. Returns ``(tree, extras)``."""
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

    def leaf(key, _):
        return _from_numpy(data[key], manifest["dtypes"][key]).to(
            device or "cpu")

    return _rebuild(tree_like, leaf), manifest["extras"]


def _gc(directory: str, keep: int) -> None:
    for s in _step_ids(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
