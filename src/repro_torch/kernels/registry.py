"""Kernel dispatch for the port: one entry point per kernel op.

Port of ``repro.kernels.registry`` with the backend policy the card needs:

  * a CUDA tensor goes to the op's hand-written CUDA kernel — or the call
    raises (unsupported dtype, failed build, refused launch);
  * a CPU tensor goes to the op's plain PyTorch version.

There is no environment switch and no ``try`` that falls back: which
implementation runs is decided by where the data lives. Each op carries a
plain-integer launch counter that grows by one each time the kernel is
launched (:meth:`KernelOp.launch`), and nowhere else, so a run can show
that its main path went through the kernels.

Ops are made with :func:`op` (not ``kernel``: the repo's lint reserves
``X = ....kernel("name")`` in ``kernels/*/ops.py`` for the JAX registry).
"""
from __future__ import annotations

import ctypes
import importlib
from typing import Callable, Dict, Optional, Tuple

import torch

_KERNEL_MODULES = (
    "repro_torch.kernels.fp8_gemm.ops",
    "repro_torch.kernels.moe_gemm.ops",
    "repro_torch.kernels.paged_attention.ops",
)

_REGISTRY: Dict[str, "KernelOp"] = {}


def pad_to_multiple(x: torch.Tensor, dim: int, mult: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``dim`` up to the next multiple of ``mult`` (the
    one padding helper of the kernel wrappers; no copy when aligned)."""
    n = x.shape[dim]
    pad = (-n) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _first_tensor(args, kwargs) -> torch.Tensor:
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a
    raise TypeError("kernel op called without a tensor argument")


class KernelOp:
    """One logical kernel op: ``cuda`` launcher + ``plain`` version.

    ``replaces`` names the TPU kernel it ports (file:function)."""

    def __init__(self, name: str, replaces: str):
        self.name = name
        self.replaces = replaces
        self.launches = 0
        self._cuda: Optional[Callable] = None
        self._plain: Optional[Callable] = None

    def cuda(self, fn: Callable) -> Callable:
        self._cuda = fn
        return fn

    def plain(self, fn: Callable) -> Callable:
        self._plain = fn
        return fn

    def __call__(self, *args, **kwargs):
        dev = _first_tensor(args, kwargs).device
        if dev.type == "cuda":
            return self._cuda(*args, **kwargs)
        if dev.type == "cpu":
            return self._plain(*args, **kwargs)
        raise ValueError(f"kernel {self.name!r}: no implementation for "
                         f"device {dev}")

    def run_plain(self, *args, **kwargs):
        """The plain PyTorch version on any device (the kernel's oracle in
        tests and in ``chip_smoke.py``; never called by the model)."""
        return self._plain(*args, **kwargs)

    def launch(self, fn: "ctypes._CFuncPtr", *args) -> None:
        """Call a C entry of a built kernel and count the launch. The entry
        returns ``cudaGetLastError()``: a refused launch raises here."""
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"kernel {self.name!r}: CUDA launch failed "
                               f"with error {err}")
        self.launches += 1

    def __repr__(self) -> str:
        return f"KernelOp({self.name!r}, launches={self.launches})"


def op(name: str, *, replaces: str) -> KernelOp:
    """Create and register the entry point for a kernel op."""
    if name in _REGISTRY:
        raise ValueError(f"kernel {name!r} already registered")
    k = KernelOp(name, replaces)
    _REGISTRY[name] = k
    return k


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _ensure_populated() -> None:
    for mod in _KERNEL_MODULES:
        importlib.import_module(mod)


def get(name: str) -> KernelOp:
    _ensure_populated()
    return _REGISTRY[name]


def names() -> Tuple[str, ...]:
    _ensure_populated()
    return tuple(sorted(_REGISTRY))


def launch_counts() -> Dict[str, int]:
    _ensure_populated()
    return {n: k.launches for n, k in sorted(_REGISTRY.items())}


def reset_launch_counts() -> None:
    _ensure_populated()
    for k in _REGISTRY.values():
        k.launches = 0
