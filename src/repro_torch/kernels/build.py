"""Build the hand-written CUDA kernels and load them with ctypes.

Route (b) of the port's kernel guide: each ``csrc/<name>.cu`` has a plain
C interface (no PyTorch headers, so ``nvcc`` takes seconds) and compiles on
first use into ``build/kernels/<name>.<hash>.so`` at the root of the
checkout, for ``sm_90a`` only. The hash covers the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source rebuilds and an
unchanged one loads from disk. The
compiler's register/shared-memory report (``-Xptxas -v``) lands beside the
library as ``<name>.<hash>.log``.

Every C entry takes pointers and the stream as ``void*`` and returns
``cudaGetLastError()``; ``registry.KernelOp.launch`` raises if it is not
0. A failed build raises too. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source on the machine with the card")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # the shared headers count too: an edited helper rebuilds every user
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + headers
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"{name}.{h}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together. Returns seconds per source compiled;
    raises with the compiler's output if any fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, time.perf_counter())
    secs: Dict[str, float] = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n"
                          + log.decode(errors="replace"))
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return secs


def library(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives (or will)."""
    return _target(name)


def build_log(name: str) -> str:
    """The compiler's report for a built source (registers, spills)."""
    p = _target(name).with_suffix(".log")
    return p.read_text(errors="replace") if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: Sequence) -> "ctypes._CFuncPtr":
    """A C entry of ``csrc/<name>.cu`` with its argument types declared
    (pointers and the stream as ``c_void_p``, so ctypes never cuts them
    to 32 bits) and an ``int`` return (the CUDA error code)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
