"""Shared layers: norms, RoPE, dense linears (optionally on the FP8 path),
attention (direct, or the ``flash_prefill`` kernel op), GQA attention
with its dense ring (a ``window``-row ring under sliding-window
attention) and paged decode caches, SwiGLU/GeGLU MLP — port of
``repro.models.layers`` for the archs the port runs (MLA and GQA, local
attention included).

All layers are functional: ``*_specs(cfg)`` returns a ParamSpec dict,
apply functions take the materialized tensors.

Under a mesh ctx (``parallel/context``) the layers take this rank's
slices of the weights and read their head counts off them: column-parallel
products need no collective, a row-parallel product (``linear(...,
tp="row")``) sums its fp32 partials over the model group, and a paged
decode step under a data-split batch writes every data row's rows into the
replicated pool (``page_write_step``).
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import paged
from repro_torch.core.fp8 import TILE, Fp8Weight
from repro_torch.device import torch_dtype
from repro_torch.models.param import ParamSpec
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import context as pctx

# ---------------------------------------------------------------------------
# Basics
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * gamma.float()).to(dt)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation, not torch's exact
    # erf form
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu}[name]


def raw(w: Union[torch.Tensor, Fp8Weight]) -> torch.Tensor:
    """The stored weight, whether or not it carries a load-time FP8 copy."""
    return w.w if isinstance(w, Fp8Weight) else w


def linear(x: torch.Tensor, w: Union[torch.Tensor, Fp8Weight],
           cfg: Optional[ModelConfig] = None,
           b: Optional[torch.Tensor] = None,
           tp: Optional[str] = None) -> torch.Tensor:
    """Dense GEMM plus an optional bias; routes through the FP8
    fine-grained-scaled path (paper T4) when the config enables it and the
    input width is at least 256. With ``cfg.fp8_impl='pallas'`` the GEMM
    dispatches through the kernel registry (``repro_torch.kernels``).

    ``tp="row"``: under a mesh ctx ``w`` is this rank's row slice of a
    row-parallel product and x its slice of the contraction; the fp32
    partial products are summed over the model group
    (``collectives.reduce_sum``: the backward is the identity), then
    rounded once. The FP8 decision reads the global width, and an x slice
    inside one 1x128 tile is quantized with the whole tile's amax, so the
    codes are the single device's; under autograd the FP8 product is
    ``fp8_linear`` (dx and dw through ``fp8_gemm`` on the card) with that
    amax, which carries no gradient. Under a sequence cut
    (``context.seq_group``) the partials are reduce-scattered along the
    sequence (``collectives.scatter_sum``) instead. A column-parallel
    product needs no collective here: its caller passes x through
    :func:`to_columns`, once for every product that shares it."""
    group = pctx.get().tp_group if tp == "row" else None
    n = 1 if group is None else dist.get_world_size(group)
    fp8_path = (cfg is not None and cfg.fp8 and w.ndim == 2
                and x.shape[-1] * n >= 256)
    if group is None and fp8_path:
        from repro_torch.core import fp8
        y = fp8.fp8_linear(x, w, impl=cfg.fp8_impl)
    elif group is None:
        y = torch.matmul(x, raw(w).to(x.dtype))
    else:
        if fp8_path:
            from repro_torch.core import fp8
            amax = (None if x.shape[-1] % TILE == 0
                    else _tile_amax(x, group, n))
            if amax is not None and not isinstance(w, Fp8Weight) and \
                    torch.is_grad_enabled() and w.requires_grad:
                raise ValueError(
                    f"training a row-parallel FP8 linear whose contraction "
                    f"slice ({x.shape[-1]} a rank) is not whole 128-blocks: "
                    "its weight blocks would be quantized over part of a "
                    "block")
            y = fp8.fp8_linear(x, w, cfg.fp8_impl, amax, out_fp32=True)
        else:
            y = torch.matmul(x.float(), raw(w).float())
        sp = pctx.seq_group()
        if sp is not None:
            # the sequence cut: the sum reduce-scattered along it
            y = coll.scatter_sum(y, sp, x.dim() - 2).to(x.dtype)
        else:
            y = coll.reduce_sum(y, group).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def to_columns(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel region (this rank's heads or ``mlp``
    columns): ``collectives.copy_to_group`` over the model group (the
    backward sums the members' partial gradients), or, under a sequence
    cut (``context.seq_group``), this rank's chunk gathered along the
    sequence (``collectives.gather``, whose backward reduce-scatters the
    partial gradients: Megatron's sequence-parallel ``g``)."""
    sp = pctx.seq_group()
    if sp is not None:
        return coll.gather(x, sp, 1, backward="reduce_scatter")
    return coll.copy_to_group(x, pctx.get().tp_group)


def _tile_amax(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(..., 1): the amax of the 1x128 tile that this rank's slice of the
    contraction lies in, over the ranks sharing it (raises where a slice
    crosses a tile boundary). A scale carries no gradient: detached."""
    from repro_torch.parallel.sharding import cut_blocks
    kl = x.shape[-1]
    me = dist.get_rank(group)
    cut_blocks(kl * n, n, me, TILE)
    a = x.detach().float().abs().amax(dim=-1, keepdim=True)
    every = coll.all_gather(a[None], group)              # (n, ..., 1)
    tile = me * kl // TILE
    members = [r for r in range(n) if r * kl // TILE == tile]
    return every[members].amax(dim=0)


def page_write_step(cache: dict, rows: dict, table: torch.Tensor,
                    qpos: torch.Tensor, dp_write=None) -> None:
    """One decode step's rows (``rows``: leaf name -> ``(B, ...)``) into
    the cache's pools (``paged.page_write``). Under a data-split batch
    (``dp_write = (group, full table, every slot's position)``) the rows
    of every data row's slots are gathered and written on every rank, so
    the replicated pool stays whole: every leaf's rows cross in one
    gather, their bytes side by side."""
    if dp_write is not None:
        group, table, qpos = dp_write
        B = next(iter(rows.values())).shape[0]
        parts = [v.contiguous().view(torch.uint8).reshape(B, -1)
                 for v in rows.values()]
        every = coll.all_gather(torch.cat(parts, dim=1), group)
        out, at = {}, 0
        for (name, v), part in zip(rows.items(), parts):
            w = part.shape[1]
            out[name] = every[:, at:at + w].contiguous().view(v.dtype) \
                .reshape(every.shape[0], *v.shape[1:])
            at += w
        rows = out
    for name, v in rows.items():
        paged.page_write(cache[name], table, qpos, v)


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
# Attention
# ---------------------------------------------------------------------------


def gqa_specs(cfg: ModelConfig, layers: int) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_()
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    pd = cfg.param_dtype
    L, la = (layers,), ("layers",)
    specs = {
        "wq": ParamSpec(L + (d, nh * hd), pd, la + ("embed", "heads"), "fan_in"),
        "wk": ParamSpec(L + (d, nkv * hd), pd, la + ("embed", "kv_heads"), "fan_in"),
        "wv": ParamSpec(L + (d, nkv * hd), pd, la + ("embed", "kv_heads"), "fan_in"),
        "wo": ParamSpec(L + (nh * hd, d), pd, la + ("heads", "embed"), "fan_in"),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec(L + (nh * hd,), pd, la + ("heads",), "zeros")
        specs["bk"] = ParamSpec(L + (nkv * hd,), pd, la + ("kv_heads",), "zeros")
        specs["bv"] = ParamSpec(L + (nkv * hd,), pd, la + ("kv_heads",), "zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec(L + (hd,), pd, la + (None,), "ones")
        specs["k_norm"] = ParamSpec(L + (hd,), pd, la + (None,), "ones")
    return specs


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)


def _attn_direct(q, k, v, *, causal: bool, q_pos, k_pos, scale: float,
                 window: int = 0):
    """Unchunked attention. q: (B,S,H,hd) k/v: (B,T,KV,hd'). Mask: attend
    iff k_pos <= q_pos (causal), q_pos - k_pos < window (if window > 0)
    and k_pos >= 0. Operands stay in the model dtype and the products
    accumulate in fp32 (the upcast is exact), as the reference's
    ``preferred_element_type=float32`` einsums."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.reshape(B, S, KV, G, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qf, k.float()) * scale
    mask = k_pos[:, None, :] >= 0
    if causal:
        mask = mask & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        mask = mask & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype).float(), v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(v.dtype)


# q-block size of the reference's chunked path: rows are independent, so
# blocking changes memory, not values
ATTN_BLOCK_Q = 512


def attention_scores(q, k, v, *, causal: bool, q_pos, k_pos,
                     scale: float = 0.0, impl: str = "xla",
                     window: int = 0):
    """Attention over query blocks: each block's S_b x T score tile lives
    only transiently. ``impl="pallas"`` sends multi-token unwindowed
    attention through the ``flash_prefill`` kernel op (block-tiled online
    softmax over the bucket: no S x T score matrix at all), as the
    reference does; windowed attention stays on the direct path there
    too."""
    B, S, H, hd = q.shape
    scale = scale or 1.0 / math.sqrt(hd)
    if (impl == "pallas" and S > 1 and not window and k.shape[-1] == hd
            and v.shape[-1] == hd):
        from repro_torch.kernels.flash_attention import ops as flash_ops
        out = flash_ops.flash_prefill(q, k, v, q_pos, k_pos, causal=causal,
                                      scale=scale)
        return out.to(v.dtype)
    bq = ATTN_BLOCK_Q
    if S <= bq or S % bq != 0:
        return _attn_direct(q, k, v, causal=causal, q_pos=q_pos,
                            k_pos=k_pos, scale=scale, window=window)
    outs = [_attn_direct(q[:, i:i + bq], k, v, causal=causal,
                         q_pos=q_pos[:, i:i + bq], k_pos=k_pos, scale=scale,
                         window=window)
            for i in range(0, S, bq)]
    return torch.cat(outs, dim=1)


def gqa_attention(p: dict, x: torch.Tensor, *, cfg: ModelConfig,
                  positions: torch.Tensor, causal: bool = True,
                  cache: Optional[dict] = None,
                  kv_x: Optional[torch.Tensor] = None,
                  kv_positions: Optional[torch.Tensor] = None,
                  page_table: Optional[torch.Tensor] = None,
                  impl: str = "xla", return_cache_entries: bool = False,
                  dp_write=None, window: int = 0):
    """GQA self- or cross-attention (also MHA/MQA; optional qk-norm and
    qkv bias); ``window`` > 0 makes it local (sliding-window) attention,
    whose dense ring holds ``window`` rows. A paged cache has no windowed
    layout: the model refuses one before a step gets here. ``causal=False``
    without a cache is the encoder's self-attention. With ``kv_x`` (B, T,
    d) it is cross-attention over that memory, as the reference's: K/V
    are projected from ``kv_x``, no RoPE, not causal, keys at
    ``kv_positions`` (B, T), and no cache logic.

    Without ``cache``: prefill over the whole sequence; with
    ``return_cache_entries`` it also returns this layer's ``(k, v)``
    (after qk-norm and RoPE), the entries the reference's
    ``_self_attention`` recomputes for cache assembly. With a dense ring
    ``cache`` (``k``/``v``/``pos``, no ``page_table``): one decode step
    that writes this token at row ``position % T`` in place and attends
    over the rows with ``0 <= pos <= position``. With ``cache`` and
    ``page_table``: one paged decode step, or a chunked-prefill run of S >
    1 tokens. ``cache`` is one layer's K/V pool slice (``core/paged.py``
    layout, written in place): the step writes its K/V (quantized under
    fp8 storage) into its slot's pages and attends over the slot's pages,
    through the ``paged_gqa_decode`` kernel op when ``impl == "pallas"``
    and S == 1, else over the gathered, dequantized pages. Returns (out,
    new_cache or entries).
    """
    hd = cfg.head_dim_()
    # this rank's heads (all of them on a single device)
    nh, nkv = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    # under a model group each rank computes its own heads: their
    # replicated inputs (x; the qk norms; whole K/V where the head cut
    # would split a KV head) enter through copy_to_group, whose backward
    # sums the ranks' partial gradients
    group = pctx.get().tp_group
    if group is not None and nh == cfg.num_heads:
        return _replicated_attention(p, x, cfg, positions, causal, cache,
                                     kv_x, kv_positions, page_table, impl,
                                     return_cache_entries, dp_write, window)
    kv_cut = nkv < cfg.num_kv_heads
    # under a sequence cut x is this rank's chunk: self-attention's K/V
    # come from the gathered sequence, whose backward sums the partial
    # gradients, so their path is the cut one's; where the KV heads stay
    # whole, each rank reads only its query heads' of them, so their
    # weights' gradients are summed over the group
    seq_kv = kv_x is None and pctx.seq_group() is not None
    summed = kv_cut or seq_kv
    xf = to_columns(x)
    q = _split_heads(linear(xf, p["wq"], cfg, p.get("bq")), nh)
    if kv_x is None:
        xk = xf if summed else x
    else:
        xk = coll.copy_to_group(kv_x, group) if kv_cut else kv_x
    kv_w = {n: p.get(n) for n in ("wk", "bk", "wv", "bv")}
    if seq_kv and not kv_cut:
        kv_w = {n: None if t is None else coll.copy_to_group(t, group)
                for n, t in kv_w.items()}
    k = _split_heads(linear(xk, kv_w["wk"], cfg, kv_w["bk"]), nkv)
    v = _split_heads(linear(xk, kv_w["wv"], cfg, kv_w["bv"]), nkv)
    if cfg.qk_norm:
        q = rmsnorm(q, coll.copy_to_group(p["q_norm"], group), cfg.rms_eps)
        k = rmsnorm(k, coll.copy_to_group(p["k_norm"], group)
                    if summed else p["k_norm"], cfg.rms_eps)
    k_pos = positions if kv_positions is None else kv_positions
    if kv_x is None:                    # self-attention: RoPE
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, k_pos, cfg.rope_theta)
    else:
        causal = False
    if not summed:
        k, v = coll.copy_to_group(k, group), coll.copy_to_group(v, group)
    sel = _kv_heads_of(nh, nkv, cfg)

    aux = None
    if cache is None:
        out = attention_scores(q, k[..., sel, :], v[..., sel, :],
                               causal=causal, q_pos=positions,
                               k_pos=k_pos, impl=impl, window=window)
        if return_cache_entries:
            aux = (k, v)
    elif page_table is None:
        out = _ring_decode(q, k, v, cache, cfg=cfg, positions=positions,
                           impl=impl, sel=sel, window=window)
        aux = cache
    else:
        out = _paged_decode(q, k, v, cache, cfg=cfg, positions=positions,
                            page_table=page_table, impl=impl,
                            dp_write=dp_write, sel=sel)
        aux = cache
    out = out.reshape(*out.shape[:-2], nh * hd)
    return linear(out, p["wo"], cfg, tp="row"), aux


def _replicated_attention(p, x, cfg, positions, causal, cache, kv_x,
                          kv_positions, page_table, impl,
                          return_cache_entries, dp_write, window):
    """:func:`gqa_attention` where the heads do not split over the model
    group (``sharding.whole_heads``): every rank holds every head and runs
    the single device's attention, with no collective; under a sequence
    cut the sequence is gathered in (its consumer is replicated: the
    backward takes this rank's slice) and this rank's part of the output
    is taken (``collectives.split``: the backward gathers the parts'
    gradients, so every replicated weight's gradient is whole on every
    rank)."""
    sp = pctx.seq_group()
    if sp is not None:
        x = coll.gather(x, sp, 1, backward="slice")
    with pctx.use(pctx.ParallelCtx()):
        out, aux = gqa_attention(
            p, x, cfg=cfg, positions=positions, causal=causal, cache=cache,
            kv_x=kv_x, kv_positions=kv_positions, page_table=page_table,
            impl=impl, return_cache_entries=return_cache_entries,
            dp_write=dp_write, window=window)
    if sp is not None:
        out = coll.split(out, sp, 1)
    return out, aux


def kv_amax_reduce(nkv: int, cfg: ModelConfig):
    """Where this rank holds ``nkv`` of the config's KV heads (a KV-head
    cut), the max over the model group that makes a token's FP8 scale the
    whole (KV, hd) entry's, as on one device; else None."""
    group = pctx.get().tp_group
    if group is None or nkv == cfg.num_kv_heads:
        return None
    return lambda amax: coll.all_reduce(amax.detach(), group, op="max")


def _kv_heads_of(nh: int, nkv: int, cfg: ModelConfig) -> slice:
    """The KV heads this rank's ``nh`` query heads read. All of them on a
    single device or under a head-aligned cut; where the mesh's head cut
    would split a KV head, K/V stay replicated (written whole) and each
    rank reads the KV heads of its query heads."""
    G = cfg.num_heads // cfg.num_kv_heads
    if nkv * G == nh:
        return slice(None)
    if nh % G and G % nh:
        raise ValueError(f"{nh} query heads a rank over KV groups of {G}: "
                         "a rank's query heads must cover whole groups or "
                         "lie inside one")
    c = pctx.get()
    lo = c.index(c.tp_axis) * nh // G
    return slice(lo, lo + max(1, nh // G))


def _ring_decode(q, k, v, cache: dict, *, cfg: ModelConfig, positions,
                 impl: str, sel: slice = slice(None),
                 window: int = 0) -> torch.Tensor:
    """The dense ring branch of :func:`gqa_attention`: write k, v (B, 1,
    KV, hd) at ring row ``position % T`` of each slot, then attend with the
    ring's ``pos`` as key positions (-1 rows are empty) and, under a
    ``window``, only over the last ``window`` positions."""
    B, T = cache["pos"].shape
    idx = (positions[:, 0] % T).long()
    ba = torch.arange(B, device=q.device)
    cache["k"][ba, idx] = k[:, 0].to(cache["k"].dtype)
    cache["v"][ba, idx] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][ba, idx] = positions[:, 0].to(torch.int32)
    cdt = torch_dtype(cfg.dtype)
    return attention_scores(q, cache["k"][..., sel, :].to(cdt),
                            cache["v"][..., sel, :].to(cdt),
                            causal=True, q_pos=positions,
                            k_pos=cache["pos"], impl=impl, window=window)


def _paged_decode(q, k, v, cache: dict, *, cfg: ModelConfig, positions,
                  page_table, impl: str, dp_write=None,
                  sel: slice = slice(None)) -> torch.Tensor:
    """The paged branch of :func:`gqa_attention`. S == 1 is the decode
    step; S > 1 is a page-aligned chunked-prefill run (``positions[:, 0]``
    on a page boundary, S a multiple of the page size), written whole pages
    first with :func:`paged.page_write_chunk` and attended over the slot's
    gathered pages with per-query validity (``flash_prefill`` with S = C
    queries against T = ``max_len`` keys on ``impl="pallas"``). Returns
    (B, S, H, hd) in the model dtype."""
    S = q.shape[1]
    qpos = positions[:, 0]
    fp8 = "k_scale" in cache
    cdt = torch_dtype(cfg.dtype)

    def write(rows):
        if S == 1:
            page_write_step(cache, {n: x[:, 0] for n, x in rows.items()},
                            page_table, qpos, dp_write)
        else:
            for n, x in rows.items():
                paged.page_write_chunk(cache[n], page_table, qpos, x)

    if fp8:
        reduce = kv_amax_reduce(k.shape[-2], cfg)
        qk, sk = paged.quantize_vecs(k, vec_ndim=2, reduce=reduce)
        qv, sv = paged.quantize_vecs(v, vec_ndim=2, reduce=reduce)
        write({"k": qk, "v": qv, "k_scale": sk, "v_scale": sv})
    else:
        write({"k": k, "v": v})

    if impl == "pallas" and S == 1:
        from repro_torch.kernels.paged_attention import ops as paged_ops
        o = paged_ops.paged_gqa_decode(          # native pools: unit scales
            q[:, 0].float(), cache["k"][..., sel, :],
            cache["v"][..., sel, :], cache.get("k_scale"),
            cache.get("v_scale"), page_table, qpos,
            scale=1.0 / math.sqrt(cfg.head_dim_()))
        return o[:, None].to(cdt)
    if fp8:
        kc = paged.gather_dequant(cache["k"], cache["k_scale"], page_table,
                                  vec_ndim=2).to(cdt)
        vc = paged.gather_dequant(cache["v"], cache["v_scale"], page_table,
                                  vec_ndim=2).to(cdt)
    else:
        kc = paged.table_gather(cache["k"], page_table).to(cdt)
        vc = paged.table_gather(cache["v"], page_table).to(cdt)
    kc, vc = kc[..., sel, :], vc[..., sel, :]
    # positional validity: the logical index is the position (pages never
    # ring-wrap), so the causal mask k_pos <= q_pos is exactly "written by
    # this slot" (and, per query of a chunk, intra-chunk causality); stale
    # and trash rows sit above qpos
    T = kc.shape[1]
    kpos = torch.arange(T, dtype=torch.int32,
                        device=q.device).expand(kc.shape[0], T)
    return attention_scores(q, kc, vc, causal=True, q_pos=positions,
                            k_pos=kpos, impl=impl)


def init_gqa_cache(cfg: ModelConfig, layers: int, batch: int, max_len: int,
                   device: torch.device, window: int = 0) -> dict:
    """Dense K/V ring: ``k``/``v`` ``(layers, batch, T, KV, hd)`` in the
    cache dtype and ``pos`` ``(layers, batch, T)`` int32, -1 where a row is
    empty. ``T = max_len``, or ``min(max_len, window)`` for windowed
    attention (RecurrentGemma's bounded cache)."""
    T = min(max_len, window) if window else max_len
    dt = torch_dtype(cfg.cache_dtype_())
    shape = (layers, batch, T, cfg.num_kv_heads, cfg.head_dim_())
    return dict(k=torch.zeros(shape, dtype=dt, device=device),
                v=torch.zeros(shape, dtype=dt, device=device),
                pos=torch.full(shape[:3], -1, dtype=torch.int32,
                               device=device))


def init_paged_gqa_cache(cfg: ModelConfig, layers: int, pool_pages: int,
                         page_size: int, storage: str,
                         device: torch.device) -> dict:
    """K/V page pool (no batch axis: pages are shared across slots).

    Leaves ``(layers, pool_pages+1, page, KV, hd)``; the last page is the
    trash page. FP8 storage holds E4M3 bytes (uint8) and adds per-token
    fp32 scale leaves ``(layers, P+1, page)`` (one scale over a token's
    whole ``(KV, hd)`` entry). No ``pos`` leaf: validity is positional."""
    paged.validate_storage(storage)
    fp8 = storage == "fp8"
    dt = torch.uint8 if fp8 else torch_dtype(cfg.cache_dtype_())
    shape = (layers, pool_pages + 1, page_size, cfg.num_kv_heads,
             cfg.head_dim_())
    c = dict(k=torch.zeros(shape, dtype=dt, device=device),
             v=torch.zeros(shape, dtype=dt, device=device))
    if fp8:
        for name in ("k_scale", "v_scale"):
            c[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                  device=device)
    return c


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
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
    """SwiGLU (GeGLU under ``act="gelu"``); under a model group
    column-parallel over ``mlp`` (x enters through :func:`to_columns`),
    ``w_down`` row-parallel."""
    x = to_columns(x)
    g = act_fn(cfg.act)(linear(x, p["w_gate"], cfg))
    u = linear(x, p["w_up"], cfg)
    return linear(g * u, p["w_down"], cfg, tp="row")
