"""Kernel dispatch for the port: one entry point per kernel op.

Port of ``repro.kernels.registry`` with the backend policy the card needs:

  * a CUDA tensor goes to the op's hand-written CUDA kernel — or the call
    raises (unsupported dtype, failed build, refused launch);
  * a CPU tensor goes to the op's plain PyTorch version.

There is no environment switch and no ``try`` that falls back: which
implementation runs is decided by where the data lives.

A kernel writes its output through ctypes, out of autograd's sight: a
loss reaching one with grad enabled would get silently zero gradients.
So a CUDA dispatch raises while grad mode is on and a tensor argument
requires grad (inside an ``autograd.Function``, as the FP8 linear's
``fp8_gemm`` launches run, grad mode is off). The plain versions
differentiate, as the reference's do; its Pallas kernels have no VJP
either.

Each op carries a plain-integer launch counter that grows by one each
time the kernel is launched (:meth:`KernelOp.launch`), and nowhere else,
so a run can show that its main path went through the kernels.

Under CUDA graph capture a launch runs nothing: the graph launches the
kernel at each replay. So a capture is made inside :func:`tally`, which
collects the launches made while it is open instead of counting them,
and the graph's owner adds that tally to the counters once for each
replay (:func:`add_launches`). A launch while the stream is capturing
outside a tally raises, so no replayed kernel goes uncounted.

Ops are made with :func:`op` (not ``kernel``: the repo's lint reserves
``X = ....kernel("name")`` in ``kernels/*/ops.py`` for the JAX registry).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import importlib
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

_KERNEL_MODULES = (
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.fp8_gemm.ops",
    "repro_torch.kernels.logfmt.ops",
    "repro_torch.kernels.mla_attention.ops",
    "repro_torch.kernels.moe_gemm.ops",
    "repro_torch.kernels.paged_attention.ops",
)

_REGISTRY: Dict[str, "KernelOp"] = {}

# the open tallies, innermost last (see :func:`tally`)
_TALLIES: list = []


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


def contiguous16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned base, for kernels that read
    rows in 16-byte vectors (a copy only when a view starts off the
    boundary)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


# the ROADMAP item each kernel's backward waits for: training (A.9), and
# for the experts expert parallelism (A.8)
_BACKWARD_ITEM = {"moe_gemm": "A.8"}


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
            if torch.is_grad_enabled() and any(
                    isinstance(a, torch.Tensor) and a.requires_grad
                    for a in list(args) + list(kwargs.values())):
                raise RuntimeError(
                    f"kernel {self.name!r} has no backward: its CUDA launch "
                    "would give zero gradients. Training runs it only "
                    "inside an autograd.Function (not ported yet: see "
                    "ROADMAP.md, "
                    f"{_BACKWARD_ITEM.get(self.name, 'A.9')})")
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
        """Call a C entry of a built kernel and count the launch, or, inside
        a :func:`tally`, add it to the innermost tally. The entry returns
        ``cudaGetLastError()``: a refused launch raises here."""
        t = _TALLIES[-1] if _TALLIES else None
        if t is None and torch.cuda.is_available() and (
                torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                f"kernel {self.name!r} launched under CUDA graph capture "
                "outside registry.tally(): its replays would go uncounted")
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"kernel {self.name!r}: CUDA launch failed "
                               f"with error {err}")
        if t is None:
            self.launches += 1
        else:
            t[self.name] = t.get(self.name, 0) + 1

    def __repr__(self) -> str:
        return f"KernelOp({self.name!r}, launches={self.launches})"


def op(name: str, *, replaces: str) -> KernelOp:
    """Create and register the entry point for a kernel op."""
    if name in _REGISTRY:
        raise ValueError(f"kernel {name!r} already registered")
    k = KernelOp(name, replaces)
    _REGISTRY[name] = k
    return k


@functools.cache
def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device (the split plans of the
    kernels that spread work over every SM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """A tensor's device address for a C entry; ``None`` is the null
    pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


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


@contextlib.contextmanager
def tally() -> Iterator[Dict[str, int]]:
    """Collect the launches made while open into a ``{name: count}`` dict
    instead of counting them: open it around a CUDA graph capture, whose
    launches run only when the graph is replayed."""
    t: Dict[str, int] = {}
    _TALLIES.append(t)
    try:
        yield t
    finally:
        _TALLIES.pop()


def add_launches(t: Dict[str, int], times: int = 1) -> None:
    """Count a tally's launches ``times`` times: once for each replay of
    the graph it was collected from."""
    for name, n in t.items():
        _REGISTRY[name].launches += n * times


def reset_launch_counts() -> None:
    _ensure_populated()
    for k in _REGISTRY.values():
        k.launches = 0
