"""Transformer blocks (dense and MoE, MLA attention) — port of the parts
of ``repro.models.transformer`` the MLA archs run. Pre-norm residual
blocks; ``*_block_specs(cfg, n)`` returns a ParamSpec dict whose leaves
stack ``n`` layers on their leading axis; ``block_apply`` consumes one
layer slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mla as mla_mod
from repro_torch.core import moe as moe_mod
from repro_torch.models import layers as Lyr
from repro_torch.models.param import ParamSpec


def _norm_spec(cfg: ModelConfig, n: int) -> ParamSpec:
    return ParamSpec((n, cfg.d_model), cfg.param_dtype, ("layers", None),
                     "ones")


def attn_specs(cfg: ModelConfig, n: int) -> dict:
    if cfg.attention == "mla":
        return mla_mod.mla_specs(cfg, n)
    raise NotImplementedError(
        f"attention={cfg.attention!r}: the port runs MLA only so far; GQA "
        "comes with the qwen3-14b slice (ROADMAP.md, A.2)")


def dense_block_specs(cfg: ModelConfig, n: int,
                      d_ff: Optional[int] = None) -> dict:
    return {
        "ln1": _norm_spec(cfg, n),
        "attn": attn_specs(cfg, n),
        "ln2": _norm_spec(cfg, n),
        "mlp": Lyr.mlp_specs(cfg, n, d_ff),
    }


def moe_block_specs(cfg: ModelConfig, n: int) -> dict:
    return {
        "ln1": _norm_spec(cfg, n),
        "attn": attn_specs(cfg, n),
        "ln2": _norm_spec(cfg, n),
        "moe": moe_mod.moe_specs(cfg, n),
    }


def _self_attention(p: dict, h: torch.Tensor, cfg: ModelConfig, ctx: dict,
                    cache):
    """MLA self-attention. With a pool slice in ``cache`` this is the
    paged decode step (the page table rides in ctx); without, prefill,
    which returns the layer's latent entries when ``collect_cache``."""
    if cache is not None:
        return mla_mod.mla_paged_decode_step(
            p, cache, h, cfg=cfg, positions=ctx["positions"],
            page_table=ctx["page_table"], impl=ctx.get("mla_impl", "xla"))
    if ctx.get("collect_cache"):
        return mla_mod.mla_attention(p, h, cfg=cfg,
                                     positions=ctx["positions"],
                                     return_cache_entries=True)
    return mla_mod.mla_attention(p, h, cfg=cfg,
                                 positions=ctx["positions"]), None


def _ffn(p: dict, h: torch.Tensor, cfg: ModelConfig, ctx: dict):
    """Routed-MoE or dense FFN (single device)."""
    if "moe" in p:
        y, _, _ = moe_mod.moe_ffn(p["moe"], h, cfg, valid=ctx.get("valid"),
                                  weights_qdq=ctx.get("weights_qdq", False))
        return y
    return Lyr.mlp(p["mlp"], h, cfg)


def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: dict,
                cache=None):
    """Dense or MoE self-attention block. Returns (x, cache_out)."""
    h, cache_out = _self_attention(p["attn"],
                                   Lyr.rmsnorm(x, p["ln1"], cfg.rms_eps),
                                   cfg, ctx, cache)
    x = x + h
    f = _ffn(p, Lyr.rmsnorm(x, p["ln2"], cfg.rms_eps), cfg, ctx)
    return x + f, cache_out
