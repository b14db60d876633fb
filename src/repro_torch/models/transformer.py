"""Transformer blocks — port of ``repro.models.transformer``: dense and
MoE blocks (MLA or GQA attention; GQA also as the local attention of the
hybrid family), the enc-dec family's encoder block (non-causal) and
decoder block (self-attention, cross-attention over the encoder's
memory, FFN), and the vision family's gated cross-attention block.
Pre-norm residual blocks; ``*_block_specs(cfg, n)`` returns a ParamSpec
dict whose leaves stack ``n`` layers on their leading axis (a tuple
``n`` stacks them on several, as the vision pattern's self layers);
``block_apply`` consumes one layer slice and returns, as the reference's,
the layer's MoE stats beside its output and cache (``aux_loss``,
``load``, ``drop``; computed when ``ctx["stats"]`` is set: the loss sets
it, serving reads none).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mla as mla_mod
from repro_torch.core import moe as moe_mod
from repro_torch.models import layers as Lyr
from repro_torch.models.param import ParamSpec
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import context as pctx


# the attention kinds that run GQA: "local" is the hybrid family's
# sliding-window attention (its window rides in the block's ctx)
GQA_KINDS = ("gqa", "local")


def _norm_spec(cfg: ModelConfig, n: int) -> ParamSpec:
    return ParamSpec((n, cfg.d_model), cfg.param_dtype, ("layers", None),
                     "ones")


def _prefixed(specs: dict, outer: Tuple[int, ...]) -> dict:
    """``specs`` (built for one stacked layer axis) with the ``outer``
    scan axes in front of every leaf: the reference's nested stacks."""
    if not outer:
        return specs
    if isinstance(specs, ParamSpec):
        return dataclasses.replace(
            specs, shape=tuple(outer) + specs.shape,
            axes=("layers",) * len(outer) + specs.axes)
    return {k: _prefixed(v, outer) for k, v in specs.items()}


def attn_specs(cfg: ModelConfig, n: int) -> dict:
    if cfg.attention == "mla":
        return mla_mod.mla_specs(cfg, n)
    if cfg.attention in GQA_KINDS:
        return Lyr.gqa_specs(cfg, n)
    raise ValueError(f"attention={cfg.attention!r}: not an attention kind "
                     f"of the reference (mla, {', '.join(GQA_KINDS)})")


def dense_block_specs(cfg: ModelConfig, n: Union[int, Tuple[int, ...]],
                      d_ff: Optional[int] = None) -> dict:
    prefix = (n,) if isinstance(n, int) else tuple(n)
    m = prefix[-1]
    return _prefixed({
        "ln1": _norm_spec(cfg, m),
        "attn": attn_specs(cfg, m),
        "ln2": _norm_spec(cfg, m),
        "mlp": Lyr.mlp_specs(cfg, m, d_ff),
    }, prefix[:-1])


def cross_block_specs(cfg: ModelConfig, n: int) -> dict:
    """The vision family's gated cross-attention layer, with its own FFN:
    K/V from the patch embeddings; both gates start at zero (the
    reference's init), so a fresh layer adds nothing."""
    return {
        "ln1": _norm_spec(cfg, n),
        "xattn": Lyr.gqa_specs(cfg, n),
        "gate_attn": ParamSpec((n,), cfg.param_dtype, ("layers",), "zeros"),
        "ln2": _norm_spec(cfg, n),
        "mlp": Lyr.mlp_specs(cfg, n),
        "gate_mlp": ParamSpec((n,), cfg.param_dtype, ("layers",), "zeros"),
    }


def decoder_block_specs(cfg: ModelConfig, n: int) -> dict:
    """The enc-dec decoder block: self-attention, cross-attention, FFN."""
    return {
        "ln1": _norm_spec(cfg, n),
        "attn": Lyr.gqa_specs(cfg, n),
        "lnx": _norm_spec(cfg, n),
        "xattn": Lyr.gqa_specs(cfg, n),
        "ln2": _norm_spec(cfg, n),
        "mlp": Lyr.mlp_specs(cfg, n),
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
    """MLA or GQA self-attention. With a cache slice this is one decode
    step: over the dense ring when the slice has a ``pos`` leaf, else over
    the page pool (the page table rides in ctx). Without, prefill, which
    returns the layer's cache entries (MLA latents, GQA ``(k, v)``) when
    ``collect_cache``. ``ctx["window"]`` (set by a windowed segment) makes
    GQA local attention; ``ctx["causal"]`` False (the encoder's) makes it
    non-causal."""
    paged = cache is not None and "pos" not in cache
    if cfg.attention in GQA_KINDS:
        return Lyr.gqa_attention(
            p, h, cfg=cfg, positions=ctx["positions"],
            causal=ctx.get("causal", True), cache=cache,
            page_table=ctx["page_table"] if paged else None,
            impl=ctx.get("gqa_impl", "xla"),
            return_cache_entries=bool(ctx.get("collect_cache")),
            dp_write=ctx.get("dp_write"), window=ctx.get("window", 0))
    if paged:
        return mla_mod.mla_paged_decode_step(
            p, cache, h, cfg=cfg, positions=ctx["positions"],
            page_table=ctx["page_table"], impl=ctx.get("mla_impl", "xla"),
            dp_write=ctx.get("dp_write"))
    if cache is not None:
        return mla_mod.mla_decode_step(
            p, cache, h, cfg=cfg, positions=ctx["positions"],
            impl=ctx.get("mla_impl", "xla"))
    if ctx.get("collect_cache"):
        return mla_mod.mla_attention(p, h, cfg=cfg,
                                     positions=ctx["positions"],
                                     return_cache_entries=True)
    return mla_mod.mla_attention(p, h, cfg=cfg,
                                 positions=ctx["positions"]), None


def _ffn(p: dict, h: torch.Tensor, cfg: ModelConfig, ctx: dict):
    """Routed-MoE or dense FFN. Returns (y, stats). Under a mesh ctx with
    an EP ``moe_impl`` the MoE runs ``parallel/ep.moe_ffn_sharded`` (the
    reference's ``transformer.py`` dispatch); ``ctx["batch_sharded"]``
    says the tokens are this data row's own (decode), not the same on
    every row (a batch-1 prefill)."""
    return coll.drive(_ffn_phases(p, h, cfg, ctx))


def _ffn_phases(p: dict, h: torch.Tensor, cfg: ModelConfig, ctx: dict):
    """:func:`_ffn` as phases (``collectives.drive``): the EP MoE yields
    with each of its collectives in flight; the rest runs through."""
    if "moe" in p:
        stats = bool(ctx.get("stats"))
        c = pctx.get()
        if c.ep_enabled:
            from repro_torch.parallel import ep
            y, rr, drop = yield from ep.moe_ffn_phases(
                p["moe"], h, cfg, c, valid=ctx.get("valid"),
                weights_qdq=ctx.get("weights_qdq", False),
                replicated=not ctx.get("batch_sharded", False), stats=stats)
        else:
            y, rr, drop = moe_mod.moe_ffn(
                p["moe"], h, cfg, valid=ctx.get("valid"),
                weights_qdq=ctx.get("weights_qdq", False), stats=stats)
        if not stats:
            return y, {}
        return y, {"aux_loss": rr.aux_loss, "load": rr.load,
                   "drop": drop.detach()}
    return Lyr.mlp(p["mlp"], h, cfg), {}


def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: dict,
                cache=None):
    """Dense or MoE self-attention block. Returns (x, cache_out, stats)."""
    return coll.drive(block_phases(p, x, cfg, ctx, cache))


def block_phases(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: dict,
                 cache=None):
    """:func:`block_apply` as phases (``collectives.drive``): attention and
    the gate, then the EP MoE's dispatch and combine, each yield with a
    collective in flight (``parallel/overlap.py`` runs two blocks' phases
    in turns). The attention's tensor-parallel reductions run through."""
    coll.mark("attention")
    # under a sequence cut x is this rank's chunk of tokens: the norms and
    # the residual adds run on it, so a norm weight's gradient is this
    # rank's tokens' part, summed over the group (``copy_to_group``)
    sp = pctx.seq_group()
    h, cache_out = _self_attention(
        p["attn"], Lyr.rmsnorm(x, coll.copy_to_group(p["ln1"], sp),
                               cfg.rms_eps), cfg, ctx, cache)
    x = x + h
    f, stats = yield from _ffn_phases(
        p, Lyr.rmsnorm(x, coll.copy_to_group(p["ln2"], sp), cfg.rms_eps),
        cfg, ctx)
    return x + f, cache_out, stats


def _cross_attention(p: dict, h: torch.Tensor, cfg: ModelConfig,
                     ctx: dict) -> torch.Tensor:
    """Attention of ``h`` over ``ctx["memory"]`` at ``ctx["mem_positions"]``
    (non-causal, no RoPE, no cache, plain path: the reference passes no
    ``impl``)."""
    return Lyr.gqa_attention(p, h, cfg=cfg, positions=ctx["positions"],
                             causal=False, kv_x=ctx["memory"],
                             kv_positions=ctx["mem_positions"])[0]


def cross_block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      ctx: dict, cache=None):
    """The gated cross-attention block (vision): ``tanh(gate_attn)`` times
    the cross-attention, then ``tanh(gate_mlp)`` times the FFN. Returns
    (x, None, {})."""
    # under a sequence cut x is this rank's chunk of tokens: the norms'
    # and the gates' gradients are summed over the group
    sp = pctx.seq_group()
    ln1, ln2, ga, gm = (coll.copy_to_group(p[k], sp) for k in
                        ("ln1", "ln2", "gate_attn", "gate_mlp"))
    out = _cross_attention(p["xattn"], Lyr.rmsnorm(x, ln1, cfg.rms_eps),
                           cfg, ctx)
    x = x + torch.tanh(ga).to(x.dtype) * out
    f = Lyr.mlp(p["mlp"], Lyr.rmsnorm(x, ln2, cfg.rms_eps), cfg)
    return x + torch.tanh(gm).to(x.dtype) * f, None, {}


def decoder_block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                        ctx: dict, cache=None):
    """The enc-dec decoder block: self-attention (over ``cache`` in
    decode, returning its entries in prefill, as :func:`block_apply`),
    cross-attention over the memory, FFN. Returns (x, cache_out, {})."""
    # under a sequence cut x is this rank's chunk of tokens: the norms'
    # gradients are summed over the group
    sp = pctx.seq_group()
    ln1, lnx, ln2 = (coll.copy_to_group(p[k], sp) for k in
                     ("ln1", "lnx", "ln2"))
    out, cache_out = _self_attention(
        p["attn"], Lyr.rmsnorm(x, ln1, cfg.rms_eps), cfg, ctx, cache)
    x = x + out
    x = x + _cross_attention(p["xattn"], Lyr.rmsnorm(x, lnx, cfg.rms_eps),
                             cfg, ctx)
    f = Lyr.mlp(p["mlp"], Lyr.rmsnorm(x, ln2, cfg.rms_eps), cfg)
    return x + f, cache_out, {}


def encoder_block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                        ctx: dict, cache=None):
    """The encoder block: a dense block with non-causal self-attention and
    no cache."""
    return block_apply(p, x, cfg, dict(ctx, causal=False), None)
