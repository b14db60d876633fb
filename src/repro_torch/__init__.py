"""PyTorch/CUDA port of the ``repro`` package, for NVIDIA Hopper (sm_90a).

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``core``, ``models``, ``kernels``, ``serve``) so each
port module sits beside its counterpart. It imports torch, numpy and the
standard library only. Every Pallas kernel on the ported path is a CUDA
kernel written by hand under ``csrc/``, built with ``nvcc`` on first use
(``kernels/build.py``) and dispatched through ``kernels/registry.py``: a
CUDA tensor launches the kernel, a CPU tensor runs its plain PyTorch
version.

Entry points (``ServeEngine``, ``Model``, ``init_params``) run on ``cuda``
unless the caller passes ``device="cpu"``; without a card they raise.
"""
