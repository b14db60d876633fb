"""Shared layers: norms, RoPE, dense linears (optionally on the FP8 path),
direct attention, SwiGLU MLP — port of ``repro.models.layers`` for the
MLA archs. The GQA attention functions come with the GQA slice (see
ROADMAP.md).

All layers are functional: ``*_specs(cfg)`` returns a ParamSpec dict,
apply functions take the materialized tensors.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fp8 import Fp8Weight
from repro_torch.models.param import ParamSpec

# ---------------------------------------------------------------------------
# Basics
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * gamma.float()).to(dt)


def act_fn(name: str):
    return {"silu": F.silu}[name]


def raw(w: Union[torch.Tensor, Fp8Weight]) -> torch.Tensor:
    """The stored weight, whether or not it carries a load-time FP8 copy."""
    return w.w if isinstance(w, Fp8Weight) else w


def linear(x: torch.Tensor, w: Union[torch.Tensor, Fp8Weight],
           cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """Dense GEMM; routes through the FP8 fine-grained-scaled path (paper
    T4) when the config enables it and the input width is at least 256.
    With ``cfg.fp8_impl='pallas'`` the GEMM dispatches through the kernel
    registry (``repro_torch.kernels``)."""
    if cfg is not None and cfg.fp8 and w.ndim == 2 and x.shape[-1] >= 256:
        from repro_torch.core import fp8
        return fp8.fp8_linear(x, w, impl=cfg.fp8_impl)
    return torch.matmul(x, raw(w).to(x.dtype))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[..., None, :]                  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (the direct form; MLA prefill reaches only this one)
# ---------------------------------------------------------------------------


def _attn_direct(q, k, v, *, causal: bool, q_pos, k_pos, scale: float):
    """Unchunked attention. q: (B,S,H,hd) k/v: (B,T,KV,hd'). Mask: attend
    iff k_pos <= q_pos (causal) and k_pos >= 0. Operands stay in the model
    dtype and the products accumulate in fp32 (the upcast is exact), as
    the reference's ``preferred_element_type=float32`` einsums."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.reshape(B, S, KV, G, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qf, k.float()) * scale
    mask = k_pos[:, None, :] >= 0
    if causal:
        mask = mask & (k_pos[:, None, :] <= q_pos[:, :, None])
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype).float(), v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(v.dtype)


# q-block size of the reference's chunked path: rows are independent, so
# blocking changes memory, not values
ATTN_BLOCK_Q = 512


def attention_scores(q, k, v, *, causal: bool, q_pos, k_pos,
                     scale: float = 0.0):
    """Attention over query blocks (the non-kernel branch of the
    reference's ``attention_scores``): each block's S_b x T score tile
    lives only transiently."""
    B, S, H, hd = q.shape
    scale = scale or 1.0 / math.sqrt(hd)
    bq = ATTN_BLOCK_Q
    if S <= bq or S % bq != 0:
        return _attn_direct(q, k, v, causal=causal, q_pos=q_pos,
                            k_pos=k_pos, scale=scale)
    outs = [_attn_direct(q[:, i:i + bq], k, v, causal=causal,
                         q_pos=q_pos[:, i:i + bq], k_pos=k_pos, scale=scale)
            for i in range(0, S, bq)]
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, layers: int,
              d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pd = cfg.param_dtype
    L, la = (layers,), ("layers",)
    return {
        "w_gate": ParamSpec(L + (d, f), pd, la + ("embed", "mlp"), "fan_in"),
        "w_up": ParamSpec(L + (d, f), pd, la + ("embed", "mlp"), "fan_in"),
        "w_down": ParamSpec(L + (f, d), pd, la + ("mlp", "embed"), "fan_in"),
    }


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    g = act_fn(cfg.act)(linear(x, p["w_gate"], cfg))
    u = linear(x, p["w_up"], cfg)
    return linear(g * u, p["w_down"], cfg)
