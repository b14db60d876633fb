"""Device and dtype resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return DTYPES[name]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. A CUDA request on a machine without a card raises — the
    port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
