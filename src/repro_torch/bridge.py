"""Weights across the package boundary, and their load-time preparation.

* :func:`params_from_jax` copies a parameter tree that the JAX package
  made (``Model.init``), handed over as nested dicts of numpy arrays, key
  for key into torch tensors with the dtypes kept (bf16 included). Tests
  use it so that any mismatch between the packages is the port's math,
  not its random numbers.
* :func:`train_state_from_jax` carries a JAX training state (its
  parameters and ``AdamWState``, numpy leaves) across as the port's
  parameters and ``train.optimizer.AdamWState``, so both trainers can
  start from one state; :func:`to_numpy` takes a port tree back to numpy
  for comparisons.
* :func:`prepare_for_serving` does, once at load, the weight work the
  reference repeats on every call: with ``cfg.fp8`` each expert and
  shared-expert weight is replaced by its straight-through 128x128-block
  quant-dequant (forward value ``w + (qdq(w) - w)`` in the weight dtype,
  exactly as ``ste_qdq_block`` computes it), and each 2-D weight that
  reaches the FP8 ``linear`` (input width >= 256), the MTP module's
  included, gains its ``(wq, ws)`` block quantization as a
  ``core.fp8.Fp8Weight`` (the recurrent blocks' ``w_in``, ``w_out``,
  ``w_x`` and ``w_y`` too), its codes stored K-contiguous for the
  ``fp8_gemm`` kernel. Same values as the
  per-call reference; at published widths the per-call expert qdq would
  need ~15 GB of fp32 temporaries per expert matrix.
  On the kernel path (``cfg.fp8_impl == "pallas"``) the routed experts
  (``w1``, ``w3``, ``w2`` under ``moe``) are stored instead as their E4M3
  codes and block scales (``core.fp8.Fp8Experts``, 1 byte a weight), once
  :func:`check_experts` has found every dequantized matrix bit for bit
  equal to the straight-through value; a stack that fails keeps that value
  in its own dtype and is counted under ``"plain_expert_matrices"``.

With ``cfg.expert_dtype`` the routed experts are stored in that dtype:
the JAX package's E4M3 leaves (``ml_dtypes.float8_e4m3fn``) cross as
``torch.float8_e4m3fn`` with the same codes, and ``prepare_for_serving``
keeps them as they are (no qdq, no ``Fp8Experts``): the model casts them
at use with no scale, as the reference does.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import fp8

# subtrees whose 2-D weights feed models/layers.linear (the MoE router's
# "w_gate" is not one of them, nor are the expert stacks; the MTP module's
# norms are 1-D): self- and cross-attention, FFNs, the MTP module
_LINEAR_SUBTREES = ("attn", "xattn", "mlp", "mtp")
# the recurrent blocks' weights that feed linear, by name (their fp32 gate
# matrices "wa", "wi" and the depthwise "conv_w" never do)
_RECURRENT_LINEARS = ("w_in", "w_out", "w_x", "w_y")


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16: move the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":   # ml_dtypes' E4M3: the same codes
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree) -> Dict[str, Any]:
    """Nested dicts of numpy arrays -> the same nesting of CPU tensors,
    dtypes kept."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return _to_torch(tree)


def train_state_from_jax(params, opt_state, device="cpu"):
    """A JAX ``(params, AdamWState)`` with numpy leaves -> the port's
    ``(params, AdamWState)`` on ``device``, dtypes kept (fp32 master, bf16
    moments). ``opt_state`` is read by field name (``step``, ``master``,
    ``m``, ``v``); its ``None`` moment leaves (non-float parameters) have
    no counterpart in the port, whose parameters are all floating."""
    from repro_torch.train import optimizer as optim

    def move(tree):
        return optim.tree_map(lambda t: t.to(device), params_from_jax(tree))

    state = optim.AdamWState(
        _to_torch(opt_state.step).to(torch.int32).reshape(()).to(device),
        move(opt_state.master), move(opt_state.m), move(opt_state.v))
    return move(params), state


def to_numpy(tree):
    """Nested dicts (or NamedTuples) of tensors -> the same nesting of
    numpy arrays, bf16 widened to fp32 (exact), for comparisons."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _quantize_linear(w: torch.Tensor) -> fp8.Fp8Weight:
    """Block-quantize a stacked ``(..., d_in, d_out)`` weight layer by
    layer (bounded fp32 temporaries; the vision pattern's self blocks stack
    two layer axes). The codes are stored K-contiguous (``fp8.k_major``):
    an ``(..., d_out, d_in)`` buffer seen as its ``(..., d_in, d_out)``
    transpose, the ``fp8_gemm`` kernel's layout."""
    *lead, d_in, d_out = w.shape
    flat = w.reshape(-1, d_in, d_out)
    codes = torch.empty((flat.shape[0], d_out, d_in), dtype=torch.uint8,
                        device=w.device)
    scales = []
    for i in range(flat.shape[0]):
        q, s = fp8.quantize_blockwise(flat[i])
        codes[i].copy_(q.view(torch.uint8).t())
        scales.append(s)
    wq, ws = codes.view(fp8.E4M3).transpose(-1, -2), torch.stack(scales)
    if len(lead) > 1:
        wq, ws = wq.unflatten(0, lead), ws.unflatten(0, lead)
    return fp8.Fp8Weight(w, wq, ws)


def _qdq_experts(w: torch.Tensor, inplace: bool) -> torch.Tensor:
    """Straight-through block qdq of every 2-D matrix of a stacked weight
    (layers, experts), one matrix at a time."""
    out = w if inplace else torch.empty_like(w)
    flat_in = w.reshape(-1, *w.shape[-2:])
    flat_out = out.view(-1, *w.shape[-2:])
    for i in range(flat_in.shape[0]):
        flat_out[i] = fp8.ste_qdq(flat_in[i], fp8.qdq_block)
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape, dtype and bits (NaNs and the sign of zero included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    it = ints[a.element_size()]
    return torch.equal(a.contiguous().view(it), b.contiguous().view(it))


def check_experts(w: torch.Tensor, experts: fp8.Fp8Experts, inplace: bool
                  ) -> Tuple[Union[fp8.Fp8Experts, torch.Tensor], int]:
    """``(experts, 0)`` if every dequantized matrix of ``experts`` equals
    the straight-through block qdq of the same matrix of ``w`` bit for
    bit; else ``w``'s straight-through value in its own dtype (served by
    the kernel's bf16 format) and the count of its matrices. One matrix at
    a time: bounded temporaries."""
    flat = w.reshape(-1, *w.shape[-2:])
    codes = experts.wq.reshape(-1, *experts.wq.shape[-4:])
    scales = experts.ws.reshape(-1, *experts.ws.shape[-2:])
    for i in range(flat.shape[0]):
        one = fp8.Fp8Experts(codes[i], scales[i], experts.dtype,
                             experts.d_in, experts.d_out)
        if not same_bits(one.dequant(), fp8.ste_qdq(flat[i], fp8.qdq_block)):
            return _qdq_experts(w, inplace), flat.shape[0]
    return experts, 0


def expert_storage(params: Dict[str, Any]) -> Dict[str, int]:
    """The routed-expert matrices of a tree (``w1``, ``w3``, ``w2`` under
    ``moe``) by storage: ``e4m3`` in ``Fp8Experts`` containers, ``plain``
    as tensors in the weight dtype; and ``bytes``, the expert wall."""
    out = {"e4m3": 0, "plain": 0, "bytes": 0}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k in ("w1", "w3", "w2") and "moe" in path:
                kind = "e4m3" if isinstance(v, fp8.Fp8Experts) else "plain"
                out[kind] += math.prod(v.shape[:-2])
                out["bytes"] += v.nbytes

    walk(params, ())
    return out


def prepare_for_serving(params: Dict[str, Any], cfg: ModelConfig, *,
                        inplace: bool = False,
                        specs: Any = None) -> Dict[str, Any]:
    """Load-time weight preparation (see the module docstring). Returns a
    new tree marked ``"prepared": True``; the model then skips the per-call
    expert qdq. ``inplace=True`` overwrites the expert tensors of
    ``params`` instead of copying them (for an engine that owns its
    weights: no second copy of the expert wall). A tree already prepared
    is returned as it is.

    ``params`` may be a mesh rank's slice of the tree whose global
    ``ParamSpec``s are ``specs`` (the FP8 choice then reads the global
    input width): valid where every cut of a block-quantized weight falls
    on 128 boundaries (``parallel/sharding.block_cuts_ok``), since the
    block quantization of such a slice is the slice of the global one.
    Elsewhere a mesh prepares the global tree and cuts it."""
    if params.get("prepared"):
        return params
    if not cfg.fp8:
        return dict(params, prepared=True)
    fallbacks = 0

    def d_in(path, k, v):
        spec = specs
        if spec is None:
            return v.shape[-2]
        for key in path + (k,):
            spec = spec[key]
        return spec.shape[-2]

    def walk(tree, path):
        nonlocal fallbacks
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif (k in ("w1", "w3", "w2") and "moe" in path
                  and cfg.expert_dtype):
                # stored in ``expert_dtype`` and cast at use with no scale,
                # as the reference's: no qdq, no ``Fp8Experts``
                out[k] = v
            elif (k in ("w1", "w3", "w2") and "moe" in path
                  and cfg.fp8_impl == "pallas"):
                out[k], n = check_experts(v, fp8.Fp8Experts.quantize(v),
                                          inplace)
                fallbacks += n
                if inplace:
                    tree[k] = out[k]     # release the stack for its codes
            elif k in ("w1", "w3", "w2", "ws1", "ws3", "ws2") \
                    and "moe" in path:
                out[k] = _qdq_experts(v, inplace)
            elif (v.dim() >= 3 and d_in(path, k, v) >= 256
                  and (k in _RECURRENT_LINEARS
                       or any(s in path for s in _LINEAR_SUBTREES))):
                out[k] = _quantize_linear(v)
            else:
                out[k] = v
        return out

    out = walk(params, ())
    out["prepared"] = True
    out["plain_expert_matrices"] = fallbacks
    return out
