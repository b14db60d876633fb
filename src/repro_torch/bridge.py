"""Weights across the package boundary, and their load-time preparation.

* :func:`params_from_jax` copies a parameter tree that the JAX package
  made (``Model.init``), handed over as nested dicts of numpy arrays, key
  for key into torch tensors with the dtypes kept (bf16 included). Tests
  use it so that any mismatch between the packages is the port's math,
  not its random numbers.
* :func:`prepare_for_serving` does, once at load, the weight work the
  reference repeats on every call: with ``cfg.fp8`` each expert and
  shared-expert weight is replaced by its straight-through 128x128-block
  quant-dequant (forward value ``w + (qdq(w) - w)`` in the weight dtype,
  exactly as ``ste_qdq_block`` computes it), and each 2-D weight that
  reaches the FP8 ``linear`` (input width >= 256), the MTP module's
  included, gains its ``(wq, ws)`` block quantization as a
  ``core.fp8.Fp8Weight``. Same values as the
  per-call reference; at published widths the per-call expert qdq would
  need ~15 GB of fp32 temporaries per expert matrix.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fp8

# subtrees whose 2-D weights feed models/layers.linear (the MoE router's
# "w_gate" is not one of them, nor are the expert stacks; the MTP module's
# norms are 1-D)
_LINEAR_SUBTREES = ("attn", "mlp", "mtp")


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: move the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree) -> Dict[str, Any]:
    """Nested dicts of numpy arrays -> the same nesting of CPU tensors,
    dtypes kept."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return _to_torch(tree)


def _quantize_linear(w: torch.Tensor) -> fp8.Fp8Weight:
    """Block-quantize a stacked ``(n, d_in, d_out)`` weight layer by layer
    (bounded fp32 temporaries)."""
    qs = [fp8.quantize_blockwise(w[i]) for i in range(w.shape[0])]
    return fp8.Fp8Weight(w, torch.stack([q for q, _ in qs]),
                         torch.stack([s for _, s in qs]))


def _qdq_experts(w: torch.Tensor, inplace: bool) -> torch.Tensor:
    """Straight-through block qdq of every 2-D matrix of a stacked weight
    (layers, experts), one matrix at a time."""
    out = w if inplace else torch.empty_like(w)
    flat_in = w.reshape(-1, *w.shape[-2:])
    flat_out = out.view(-1, *w.shape[-2:])
    for i in range(flat_in.shape[0]):
        flat_out[i] = fp8.ste_qdq(flat_in[i], fp8.qdq_block)
    return out


def prepare_for_serving(params: Dict[str, Any], cfg: ModelConfig, *,
                        inplace: bool = False) -> Dict[str, Any]:
    """Load-time weight preparation (see the module docstring). Returns a
    new tree marked ``"prepared": True``; the model then skips the per-call
    expert qdq. ``inplace=True`` overwrites the expert tensors of
    ``params`` instead of copying them (for an engine that owns its
    weights: no second copy of the expert wall). A tree already prepared
    is returned as it is."""
    if params.get("prepared"):
        return params
    if not cfg.fp8:
        return dict(params, prepared=True)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif k in ("w1", "w3", "w2", "ws1", "ws3", "ws2") \
                    and "moe" in path:
                out[k] = _qdq_experts(v, inplace)
            elif (v.dim() == 3 and v.shape[1] >= 256
                  and any(s in path for s in _LINEAR_SUBTREES)):
                out[k] = _quantize_linear(v)
            else:
                out[k] = v
        return out

    out = walk(params, ())
    out["prepared"] = True
    return out
