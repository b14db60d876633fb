"""DeepSeekMoE layer (paper §2.2, T2) — port of ``repro.core.moe``:
fine-grained routed experts + shared expert, node-limited routing
(``core/routing``), static-capacity sort-based dispatch.

The capacity semantics are the reference's, drops included: a decode step
over a few slots gets ``capacity = 8`` rows per expert, and pad tokens of
a bucketed prefill rank below every real token and are dropped.

FP8: with ``cfg.fp8`` the reference quant-dequantizes the activations per
1x128 tile and every expert weight per 128x128 block on each call
(``ste_qdq_block``). Serving weights are frozen, so the port does the
weight half once at load (``bridge.prepare_for_serving``; same values) and
the layer is told so with ``weights_qdq=True`` — per call, at published
widths, the fp32 temporaries of the weight qdq would not fit on the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import fp8, routing
from repro_torch.models.layers import act_fn
from repro_torch.models.param import ParamSpec


def moe_specs(cfg: ModelConfig, layers: int) -> dict:
    mc = cfg.moe
    d, f = cfg.d_model, mc.expert_ff
    pd = cfg.param_dtype
    L, la = (layers,), ("layers",)
    specs = {
        "w_gate": ParamSpec(L + (d, mc.num_experts), "float32",
                            la + ("embed", None), "normal"),
        "w1": ParamSpec(L + (mc.num_experts, d, f), pd,
                        la + ("experts", "embed", "expert_ff"), "fan_in"),
        "w3": ParamSpec(L + (mc.num_experts, d, f), pd,
                        la + ("experts", "embed", "expert_ff"), "fan_in"),
        "w2": ParamSpec(L + (mc.num_experts, f, d), pd,
                        la + ("experts", "expert_ff", "embed"), "fan_in"),
    }
    if mc.router_bias:
        specs["bias"] = ParamSpec(L + (mc.num_experts,), "float32",
                                  la + (None,), "zeros")
    if mc.num_shared:
        fs = mc.shared_ff_dim() * mc.num_shared
        specs["ws1"] = ParamSpec(L + (d, fs), pd, la + ("embed", "mlp"), "fan_in")
        specs["ws3"] = ParamSpec(L + (d, fs), pd, la + ("embed", "mlp"), "fan_in")
        specs["ws2"] = ParamSpec(L + (fs, d), pd, la + ("mlp", "embed"), "fan_in")
    return specs


def ste_qdq_tile(x: torch.Tensor) -> torch.Tensor:
    """Forward value of the straight-through 1x128-tile quant-dequant."""
    return fp8.ste_qdq(x, fp8.qdq_tile)


def ste_qdq_block(w: torch.Tensor) -> torch.Tensor:
    """Forward value of the straight-through 128x128-block quant-dequant
    (per expert for a stacked ``(E, d, f)`` weight)."""
    return fp8.ste_qdq(w, fp8.qdq_block)


def expert_ffn(xbuf: torch.Tensor, w1, w3, w2, cfg: ModelConfig,
               weights_qdq: bool = False) -> torch.Tensor:
    """Grouped SwiGLU over capacity buffers. xbuf: (E, C, d).
    ``weights_qdq``: the expert weights were quant-dequantized at load."""
    if cfg.fp8:
        xbuf = ste_qdq_tile(xbuf)
        if not weights_qdq:
            w1, w3, w2 = map(ste_qdq_block, (w1, w3, w2))
    a = act_fn(cfg.act)
    dt = xbuf.dtype
    if cfg.fp8_impl == "pallas":
        from repro_torch.kernels.moe_gemm import ops as moe_ops
        h = a(moe_ops.grouped_matmul(xbuf, w1)) * moe_ops.grouped_matmul(
            xbuf, w3)
        return moe_ops.grouped_matmul(h.to(dt), w2).to(dt)
    g = torch.einsum("ecd,edf->ecf", xbuf, w1.to(dt))
    u = torch.einsum("ecd,edf->ecf", xbuf, w3.to(dt))
    h = a(g) * u
    if cfg.fp8:
        h = ste_qdq_tile(h)
    return torch.einsum("ecf,efd->ecd", h, w2.to(dt))


def shared_expert(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  weights_qdq: bool = False) -> torch.Tensor:
    if "ws1" not in p:
        return torch.zeros_like(x)
    w1, w3, w2 = p["ws1"], p["ws3"], p["ws2"]
    if cfg.fp8:
        x = ste_qdq_tile(x)
        if not weights_qdq:
            w1, w3, w2 = map(ste_qdq_block, (w1, w3, w2))
    dt = x.dtype
    h = act_fn(cfg.act)(x @ w1.to(dt)) * (x @ w3.to(dt))
    return h @ w2.to(dt)


# ---------------------------------------------------------------------------
# Capacity dispatch plan (sort-based)
# ---------------------------------------------------------------------------


def capacity(tokens: int, mc: MoEConfig) -> int:
    """Static per-expert capacity-buffer rows for ``tokens`` assignments,
    floored at 8 and rounded up to a multiple of 8 (reference rule)."""
    c = int(math.ceil(tokens * mc.top_k / mc.num_experts
                      * mc.capacity_factor))
    return max(8, -(-c // 8) * 8)


def capacity_dynamic(tokens: torch.Tensor, mc: MoEConfig) -> torch.Tensor:
    """``capacity`` for a token count held in a tensor (bucketed prefill):
    the keep threshold an exact-length dispatch would get."""
    c = torch.ceil(tokens.float() * mc.top_k * mc.capacity_factor
                   / mc.num_experts).to(torch.int64)
    return torch.clamp_min(-(-c // 8) * 8, 8)


class DispatchPlan(NamedTuple):
    dest: torch.Tensor       # (T*k,) slot in the (E*C,) buffer
    keep: torch.Tensor       # (T*k,) bool — slot within capacity
    drop_frac: torch.Tensor  # scalar fraction of dropped assignments


def dispatch_plan(expert_idx: torch.Tensor, E: int, C: int,
                  valid: Optional[torch.Tensor] = None,
                  cap_limit: Optional[torch.Tensor] = None) -> DispatchPlan:
    """expert_idx: (T, k). Slot per (token, choice), capacity C per expert,
    earlier tokens win (stable sort). ``valid`` (T,) demotes pad tokens
    below every real token and drops them; ``cap_limit`` (<= C) applies the
    exact-length keep threshold."""
    flat = expert_idx.reshape(-1).long()
    n = flat.shape[0]
    if valid is None:
        key, stride = flat, 1
    else:
        validk = valid.long().repeat_interleave(expert_idx.shape[-1])
        key, stride = flat * 2 + (1 - validk), 2
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    sorted_e = sorted_key // stride
    starts = torch.searchsorted(
        sorted_key, stride * torch.arange(E, device=flat.device))
    rank_sorted = torch.arange(n, device=flat.device) - starts[sorted_e]
    rank = torch.zeros_like(flat).scatter_(0, order, rank_sorted)
    keep = rank < (C if cap_limit is None else cap_limit)
    if valid is not None:
        keep = keep & (validk > 0)
        denom = validk.sum().clamp_min(1)
    else:
        denom = n
    dest = torch.where(keep, flat * C + rank, torch.zeros_like(flat))
    drop = 1.0 - keep.sum() / denom
    return DispatchPlan(dest, keep, drop)


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig,
            valid: Optional[torch.Tensor] = None,
            weights_qdq: bool = False
            ) -> Tuple[torch.Tensor, routing.RouteResult, torch.Tensor]:
    """Single-device MoE layer. x: (B, S, d) or (T, d). ``valid`` masks
    bucket-padding tokens out of the capacity contest. Returns (y,
    route_result, drop_frac)."""
    mc = cfg.moe
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    T = xt.shape[0]
    rr = routing.route(xt, p["w_gate"], mc,
                       bias=p.get("bias") if mc.router_bias else None)
    C = capacity(T, mc)
    if valid is None:
        plan = dispatch_plan(rr.expert_idx, mc.num_experts, C)
    else:
        v = valid.reshape(-1)
        cap_eff = torch.clamp_max(capacity_dynamic(v.sum(), mc), C)
        plan = dispatch_plan(rr.expert_idx, mc.num_experts, C,
                             valid=v, cap_limit=cap_eff)

    k = mc.top_k
    xk = xt.repeat_interleave(k, dim=0)                  # (T*k, d)
    # scatter-add of the kept rows (dropped ones add zeros at slot 0): no
    # boolean indexing, so no wait on the card
    buf = torch.zeros((mc.num_experts * C, shape[-1]), dtype=xt.dtype,
                      device=xt.device)
    buf.index_add_(0, plan.dest, xk.masked_fill(~plan.keep[:, None], 0))
    buf = buf.reshape(mc.num_experts, C, shape[-1])

    h = expert_ffn(buf, p["w1"], p["w3"], p["w2"], cfg, weights_qdq)
    h = h.reshape(mc.num_experts * C, shape[-1])

    y = h[plan.dest] * plan.keep[:, None]                # (T*k, d)
    w = rr.weights.reshape(-1)[:, None].to(y.dtype)
    y = (y * w).reshape(T, k, shape[-1]).sum(1)
    y = y + shared_expert(p, xt, cfg, weights_qdq)
    return y.reshape(shape), rr, plan.drop_frac
