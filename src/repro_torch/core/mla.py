"""Multi-head Latent Attention (paper §2.1.2, T1) — port of
``repro.core.mla`` for prefill and decode.

* **naive** (prefill): reconstruct per-head K_nope/V from the latent
  ``c_kv`` and run standard attention.
* **absorbed** (decode): the cache holds only ``(rmsnorm(c_kv), k_rope)``
  per token; W_uk is absorbed into the query and W_uv into the output, so
  each step attends against the latent rows. Two cache layouts: a dense
  ring per slot (``mla_decode_step``, rows written at ``position % T``
  with a ``pos`` leaf) and the shared page pool (``mla_paged_decode_step``).
  ``impl="pallas"`` runs that attention in the ``mla_decode`` or
  ``paged_mla_decode`` kernel op; otherwise it runs here over a dense
  latent view (the ring itself, or the gathered, dequantized pages).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import paged
from repro_torch.device import torch_dtype
from repro_torch.models.layers import (apply_rope, attention_scores, linear,
                                       page_write_step, raw, rmsnorm)
from repro_torch.models.param import ParamSpec
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import context as pctx


def mla_specs(cfg: ModelConfig, layers: int) -> dict:
    m = cfg.mla
    assert m is not None
    d, nh = cfg.d_model, cfg.num_heads
    pd = cfg.param_dtype
    L, la = (layers,), ("layers",)
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "w_dq": ParamSpec(L + (d, m.q_lora_rank), pd, la + ("embed", None), "fan_in"),
        "q_norm": ParamSpec(L + (m.q_lora_rank,), pd, la + (None,), "ones"),
        "w_uq": ParamSpec(L + (m.q_lora_rank, nh * qk), pd, la + (None, "heads"), "fan_in"),
        "w_dkv": ParamSpec(L + (d, m.kv_lora_rank), pd, la + ("embed", None), "fan_in"),
        "kv_norm": ParamSpec(L + (m.kv_lora_rank,), pd, la + (None,), "ones"),
        "w_kr": ParamSpec(L + (d, m.qk_rope_dim), pd, la + ("embed", None), "fan_in"),
        "w_uk": ParamSpec(L + (m.kv_lora_rank, nh * m.qk_nope_dim), pd,
                          la + (None, "heads"), "fan_in"),
        "w_uv": ParamSpec(L + (m.kv_lora_rank, nh * m.v_head_dim), pd,
                          la + (None, "heads"), "fan_in"),
        "w_o": ParamSpec(L + (nh * m.v_head_dim, d), pd, la + ("heads", "embed"), "fan_in"),
    }


def _heads(p: dict, cfg: ModelConfig) -> int:
    """This rank's query heads (all of them on a single device)."""
    m = cfg.mla
    return p["w_uq"].shape[-1] // (m.qk_nope_dim + m.qk_rope_dim)


def _queries(p: dict, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor):
    m = cfg.mla
    nh = _heads(p, cfg)
    cq = rmsnorm(linear(x, p["w_dq"], cfg), p["q_norm"], cfg.rms_eps)
    # the replicated latent feeds this rank's heads (``copy_to_group``:
    # its gradient is summed over the model group)
    cq = coll.copy_to_group(cq, pctx.get().tp_group)
    q = linear(cq, p["w_uq"], cfg)
    q = q.reshape(*q.shape[:-1], nh, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _latents(p: dict, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor):
    """Per-token cached quantities: normalized latent + shared RoPE key."""
    ckv = rmsnorm(linear(x, p["w_dkv"], cfg), p["kv_norm"], cfg.rms_eps)
    kr = linear(x, p["w_kr"], cfg)
    kr = apply_rope(kr[..., None, :], positions, cfg.rope_theta)[..., 0, :]
    return ckv, kr


def mla_attention(p: dict, x: torch.Tensor, *, cfg: ModelConfig,
                  positions: torch.Tensor,
                  return_cache_entries: bool = False):
    """Naive (prefill) MLA: full causal attention. x: (B, S, d). Returns
    out (B, S, d) and optionally the latent cache entries (ckv (B,S,rank),
    kr (B,S,rope)). Under a sequence cut (``context.seq_group``) x and out
    are this rank's chunk of the sequence."""
    m = cfg.mla
    nh = _heads(p, cfg)
    sp = pctx.seq_group()
    if sp is not None:
        # a sequence cut: the replicated latents run on the gathered
        # sequence, as without one (their consumers sum the gradients)
        x = coll.gather(x, sp, 1, backward="slice")
    B, S, _ = x.shape
    q_nope, q_rope = _queries(p, x, cfg, positions)
    ckv, kr = _latents(p, x, cfg, positions)
    group = pctx.get().tp_group
    ckv_f = coll.copy_to_group(ckv, group)
    kr_f = coll.copy_to_group(kr, group)
    k_nope = linear(ckv_f, p["w_uk"], cfg).reshape(B, S, nh, m.qk_nope_dim)
    v = linear(ckv_f, p["w_uv"], cfg).reshape(B, S, nh, m.v_head_dim)
    # combined-head form: K = [k_nope ; kr] (shared rope key); qk head dim
    # 192 differs from v's 128, which keeps MLA prefill on the direct path
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    kk = torch.cat([k_nope,
                    kr_f[:, :, None].expand(B, S, nh, m.qk_rope_dim)],
                   dim=-1)
    out = attention_scores(qq, kk, v, causal=True, q_pos=positions,
                           k_pos=positions, scale=scale)
    out = out.reshape(B, S, nh * m.v_head_dim).to(x.dtype)
    out = linear(out, p["w_o"], cfg, tp="row")
    if return_cache_entries:
        return out, (ckv, kr)
    return out


# ---------------------------------------------------------------------------
# Decode: latent cache (dense ring or page pool) + weight-absorbed attention
# ---------------------------------------------------------------------------


def init_mla_cache(cfg: ModelConfig, layers: int, batch: int, max_len: int,
                   device: torch.device) -> dict:
    """Dense latent ring: leaves ``ckv``/``kr`` ``(layers, batch, max_len,
    rank/rope)`` in the cache dtype and ``pos`` ``(layers, batch,
    max_len)`` int32, -1 where a row is empty."""
    m = cfg.mla
    dt = torch_dtype(cfg.cache_dtype_())
    return dict(
        ckv=torch.zeros((layers, batch, max_len, m.kv_lora_rank), dtype=dt,
                        device=device),
        kr=torch.zeros((layers, batch, max_len, m.qk_rope_dim), dtype=dt,
                       device=device),
        pos=torch.full((layers, batch, max_len), -1, dtype=torch.int32,
                       device=device),
    )



def init_paged_mla_cache(cfg: ModelConfig, layers: int, pool_pages: int,
                         page_size: int, storage: str,
                         device: torch.device) -> dict:
    """Latent page pool (no batch axis: pages are shared across slots).

    Leaves ``(layers, pool_pages+1, page, rank/rope)``; the last page is
    the trash page. FP8 storage holds E4M3 bytes (uint8) and adds one fp32
    scale per token per leaf (``ckv_scale``/``kr_scale``)."""
    m = cfg.mla
    paged.validate_storage(storage)
    fp8 = storage == "fp8"
    dt = torch.uint8 if fp8 else torch_dtype(cfg.cache_dtype_())
    P1 = pool_pages + 1
    c = dict(
        ckv=torch.zeros((layers, P1, page_size, m.kv_lora_rank), dtype=dt,
                        device=device),
        kr=torch.zeros((layers, P1, page_size, m.qk_rope_dim), dtype=dt,
                       device=device),
    )
    if fp8:
        c["ckv_scale"] = torch.zeros((layers, P1, page_size),
                                     dtype=torch.float32, device=device)
        c["kr_scale"] = torch.zeros((layers, P1, page_size),
                                    dtype=torch.float32, device=device)
    return c


def _absorb_queries(p: dict, q_nope: torch.Tensor, cfg: ModelConfig):
    """q_abs[h] = q_nope[h] @ W_uk[h]^T — queries into latent space."""
    m, nh = cfg.mla, _heads(p, cfg)
    w_uk = raw(p["w_uk"]).reshape(m.kv_lora_rank, nh, m.qk_nope_dim)
    return torch.einsum("bshn,chn->bshc", q_nope.float(), w_uk.float())


def _absorbed_attention(q_abs, q_rope, ckv, kr, valid, cfg: ModelConfig):
    """Absorbed-decode softmax over a dense latent view (the non-kernel
    path): the ring itself or the gathered pages. ckv/kr: (B, T,
    rank/rope); valid (B, T) shared by the queries, or (B, S, T) per query
    (chunked prefill, where ``l <= qpos_i`` is also intra-chunk causality).
    Operands in the compute dtype, fp32 accumulation (exact upcast).
    Returns o_lat (B, S, nh, rank) fp32."""
    m = cfg.mla
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    cdt = torch_dtype(cfg.dtype)
    if ckv.dtype != cdt:
        ckv, kr = ckv.to(cdt), kr.to(cdt)
    qa = q_abs.to(cdt).float()
    qr = q_rope.to(cdt).float()
    scores = (torch.einsum("bshc,btc->bhst", qa, ckv.float())
              + torch.einsum("bshr,btr->bhst", qr, kr.float())) * scale
    mask = valid[:, None, None, :] if valid.dim() == 2 else valid[:, None]
    scores = scores.masked_fill(~mask, -1e30)
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,btc->bshc", attn.to(cdt).float(), ckv.float())


def _absorbed_out(p: dict, o_lat: torch.Tensor, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Absorb W_uv on the way out: out[h] = o_lat[h] @ W_uv[h]."""
    m, nh = cfg.mla, _heads(p, cfg)
    B, S = o_lat.shape[:2]
    w_uv = raw(p["w_uv"]).reshape(m.kv_lora_rank, nh, m.v_head_dim)
    out = torch.einsum("bshc,chv->bshv", o_lat, w_uv.float())
    out = out.reshape(B, S, nh * m.v_head_dim).to(x.dtype)
    return linear(out, p["w_o"], cfg, tp="row")


def mla_decode_step(p: dict, cache: dict, x: torch.Tensor, *,
                    cfg: ModelConfig, positions: torch.Tensor,
                    impl: str = "xla") -> Tuple[torch.Tensor, dict]:
    """Absorbed-form decode of one token per slot over the dense ring.

    cache: one layer's ring slice — ``ckv``/``kr`` ``(B, T, ...)`` and
    ``pos`` ``(B, T)`` — written in place: this token's latents go to row
    ``position % T`` and its position to ``pos``. Attention then runs over
    every row with ``0 <= pos <= position`` (the ``mla_decode`` kernel op
    on ``impl="pallas"``). x: (B, 1, d); positions: (B, 1). Returns
    (out (B,1,d), cache)."""
    m = cfg.mla
    B, T = cache["pos"].shape
    q_nope, q_rope = _queries(p, x, cfg, positions)       # (B,1,nh,*)
    ckv_new, kr_new = _latents(p, x, cfg, positions)      # (B,1,rank/rope)

    idx = (positions[:, 0] % T).long()
    ba = torch.arange(B, device=x.device)
    cache["ckv"][ba, idx] = ckv_new[:, 0].to(cache["ckv"].dtype)
    cache["kr"][ba, idx] = kr_new[:, 0].to(cache["kr"].dtype)
    cache["pos"][ba, idx] = positions[:, 0].to(torch.int32)

    q_abs = _absorb_queries(p, q_nope, cfg)
    if impl == "pallas":
        from repro_torch.kernels.mla_attention import ops as mla_ops
        o_lat = mla_ops.mla_decode(
            q_abs[:, 0], q_rope[:, 0].float(), cache["ckv"], cache["kr"],
            cache["pos"], positions[:, 0],
            scale=1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim))
        o_lat = o_lat[:, None]
    else:
        pos = cache["pos"]
        valid = (pos >= 0) & (pos <= positions)
        o_lat = _absorbed_attention(q_abs, q_rope, cache["ckv"], cache["kr"],
                                    valid, cfg)
    return _absorbed_out(p, o_lat, x, cfg), cache


def mla_paged_decode_step(p: dict, cache: dict, x: torch.Tensor, *,
                          cfg: ModelConfig, positions: torch.Tensor,
                          page_table: torch.Tensor, impl: str = "xla",
                          dp_write=None) -> Tuple[torch.Tensor, dict]:
    """Paged absorbed-form decode of one token per slot, or a chunk of S > 1.

    cache: one layer's pool slice — ckv/kr ``(P+1, page, ...)`` plus
    ``*_scale`` under fp8 storage — written in place. page_table: (B,
    pages_per_slot). The step quantizes its latents into the slot's pages,
    then attends over the slot's pages (the ``paged_mla_decode`` kernel op
    on ``impl="pallas"``). S > 1 is a chunked-prefill run: a page-aligned
    run (``positions[:, 0]`` on a page boundary, S a multiple of the page
    size) written whole pages first, then attended with per-query validity,
    which subsumes intra-chunk causality; the kernel stays single-token, so
    S > 1 always takes the gathered, dequantized pages, as the reference's
    does. That is the reference's own non-kernel computation (its
    ``impl="xla"`` path), not a plain version of a kernel standing in for
    one. Returns (out (B,S,d), cache)."""
    m = cfg.mla
    S = x.shape[1]
    qpos = positions[:, 0]
    fp8 = "ckv_scale" in cache

    q_nope, q_rope = _queries(p, x, cfg, positions)       # (B,S,nh,*)
    ckv_new, kr_new = _latents(p, x, cfg, positions)      # (B,S,rank/rope)

    def write(rows):
        if S == 1:
            page_write_step(cache, {n: x[:, 0] for n, x in rows.items()},
                            page_table, qpos, dp_write)
        else:
            for n, x in rows.items():
                paged.page_write_chunk(cache[n], page_table, qpos, x)

    if fp8:
        qc, sc = paged.quantize_vecs(ckv_new)
        qk, sk = paged.quantize_vecs(kr_new)
        write({"ckv": qc, "kr": qk, "ckv_scale": sc, "kr_scale": sk})
    else:
        write({"ckv": ckv_new, "kr": kr_new})

    q_abs = _absorb_queries(p, q_nope, cfg)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)

    if impl == "pallas" and S == 1:
        from repro_torch.kernels.paged_attention import ops as paged_ops
        o_lat = paged_ops.paged_mla_decode(      # native pools: unit scales
            q_abs[:, 0], q_rope[:, 0].float(), cache["ckv"], cache["kr"],
            cache.get("ckv_scale"), cache.get("kr_scale"),
            page_table, qpos, scale=scale)
        o_lat = o_lat[:, None]
    else:
        if fp8:
            ckv_t = paged.gather_dequant(cache["ckv"], cache["ckv_scale"],
                                         page_table)
            kr_t = paged.gather_dequant(cache["kr"], cache["kr_scale"],
                                        page_table)
        else:
            ckv_t = paged.table_gather(cache["ckv"], page_table)
            kr_t = paged.table_gather(cache["kr"], page_table)
        T = ckv_t.shape[1]
        # positional validity: everything at or below the query's position
        # was written by this slot (pages never ring-wrap); per query for a
        # chunk, which is exactly intra-chunk causal masking
        t = torch.arange(T, device=x.device)
        if S == 1:
            valid = t[None, :] <= qpos[:, None]
        else:
            valid = t[None, None, :] <= positions[:, :, None]
        o_lat = _absorbed_attention(q_abs, q_rope, ckv_t, kr_t, valid, cfg)

    return _absorbed_out(p, o_lat, x, cfg), cache


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2,
                       storage: str = "") -> int:
    """Table 1 quantity: latent-cache bytes per token across all layers.
    ``"bf16"``: the paper's 2-byte row (70 KB/token for V3); ``"fp8"``: 1
    byte/element plus the per-token fp32 scale pair each layer."""
    m = cfg.mla
    row = m.kv_lora_rank + m.qk_rope_dim
    if storage:
        paged.validate_storage(storage)
        if storage == "fp8":
            return (row + 2 * 4) * cfg.num_layers
        dtype_bytes = 2
    return row * dtype_bytes * cfg.num_layers
