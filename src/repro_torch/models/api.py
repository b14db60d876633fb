"""Model API — port of the ``Model`` of ``repro.models.api`` for the
decoder-only transformers: MLA (DeepSeek-V3, with its MTP module) and GQA
(qwen3-14b, glm4-9b, yi-34b, qwen1.5-4b, qwen3-moe-30b-a3b and
llama4-maverick, whose ``interleave:2`` layout stacks dense/MoE pairs),
and the recurrent families: Mamba-2 SSD (mamba2-2.7b, ``models/ssm.py``)
and RecurrentGemma (recurrentgemma-9b: RG-LRU blocks and sliding-window
GQA in ``rg3`` pattern steps, ``models/rglru.py``), whose decode state
does not grow with the context and which serve on the dense cache only;
and the two families with a memory: the enc-dec family
(seamless-m4t-large-v2: a non-causal encoder over the request's frame
embeddings ``src_embeds``, whose output is the memory, and decoder blocks
that cross-attend to it) and the vision family (llama-3.2-vision-90b:
``vision_pattern`` steps of one gated cross-attention block over the
request's ``patch_embeds``, then ``cross_attn_every - 1`` self-attention
blocks). A cache of either carries the memory as a slot-resident
``memory`` leaf (batch, rows, d_model), which every decode step attends
over; the vision family has no paged layout.

    specs() / init(seed)           ParamSpec dict (the reference's key
                                   names) and materialized tensors
    loss(params, batch)            (scalar, metrics): teacher forcing with
                                   the MTP loss and the MoE diagnostics,
                                   differentiable (the training path)
    loss_dual(params, batchA, batchB)  the same over two anti-phase
                                   microbatches (``parallel/overlap.py``)
    prefill(params, batch, extra_slots=, lengths=)  (last-position logits,
                                   cache); the bucketed form pad-masks the
                                   prompt, ``extra_slots`` widens the rings;
                                   ``batch`` carries ``src_embeds`` (or a
                                   ready ``memory``) or ``patch_embeds``
    init_cache(batch, max_len)     dense ring caches (+ the MTP ring)
    cache_batch_axes(batch, max_len)  batch-axis index per cache leaf
    init_paged_cache(...)          shared page pools + per-slot page tables
    prefill_to_pages / install_pages / gather_pages / admit_pages /
    release_slot_pages
    prefill_chunk(params, cache, tokens, positions, lengths, row, slot)
                                   one page-aligned chunk of one slot's
                                   prompt, written into its pages in place
    decode_step(params, cache, tokens, positions)  over either cache
    decode_loop(params, cache, state, k, use_mtp=, overlap=)  k decode
                                   steps with on-device sampling,
                                   EOS/budget masks and the same-step MTP
                                   draft; ``overlap``: as two half-batches
                                   (dual microbatch, paper §2.3.1)
    count_params(cfg, active_only)  the reference's parameter count

Layers are stored stacked per segment (``(n, ...)`` leaves, as in the
reference); the port walks them with a Python loop where the reference
scans. PyTorch runs eagerly, so ``decode_loop`` is a loop of ``k`` steps
whose state stays on the card: the host reads it once per chunk.

Under a mesh ctx (``pctx=`` of ``prefill``, ``prefill_chunk``,
``decode_step`` and ``decode_loop``; ``parallel/context``) the params
and caches are this rank's shards and the layers issue the
tensor-parallel collectives; the
embedding lookup is masked to this rank's vocab rows and summed over the
model group, and the vocab-sharded logits are gathered, so every rank
samples the same token. A decode whose slots are split over the data axis
(``batch_sharded``) reads its own page-table rows and writes every data
row's new rows into the replicated pool.

Sampling: greedy is exact argmax. ``temperature > 0`` draws with the
port's own counter-based generator keyed by ``(request seed, stream
index)`` — the reference's invariant (a token's draw depends only on its
request and its index in the stream, whatever slot or replica runs it),
not its bits (the reference uses threefry).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.core import mla as mla_mod
from repro_torch.core import mtp as mtp_mod
from repro_torch.core import paged as paged_mod
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import layers as Lyr
from repro_torch.models import rglru as rg_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.param import (ParamSpec, init_params, layer,
                                      param_structs)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import context as pctx_mod
from repro_torch.parallel import sharding

# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding 32-bit values
    (products are masked back to 32 bits, so int64 wrap-around is
    harmless)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def counter_uniform(seeds: torch.Tensor, tix: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Uniforms in (0, 1), shape ``seeds.shape + (n,)``: a pure function
    of (seed, stream index, position), drawn on the tensors' device."""
    s = seeds.long()
    key = _mix32(_mix32(s & _M32) ^ ((s >> 32) & _M32))
    key = _mix32(key ^ _mix32((tix.long() + 0x9E3779B9) & _M32))
    j = torch.arange(n, device=seeds.device, dtype=torch.int64)
    h = _mix32(key[..., None] ^ _mix32(j * 2 + 1))
    return ((h >> 8).float() + 0.5) / float(1 << 24)


def sample_logits(logits: torch.Tensor, seeds: torch.Tensor,
                  tix: torch.Tensor, temperature: float,
                  top_k: int = 0) -> torch.Tensor:
    """Greedy (temperature <= 0) or temperature/top-k sampling over the
    last axis (Gumbel-max on the counter-based uniforms). Shared by the
    decode loop and the engine's first-token pick."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).int()
    scaled = logits.float() / temperature
    if top_k:
        kth = scaled.topk(top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    u = counter_uniform(seeds, tix, scaled.shape[-1])
    return (scaled - torch.log(-torch.log(u))).argmax(dim=-1).int()


# ---------------------------------------------------------------------------
# Segment table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    kind: str        # dense | moe | dense_moe (a dense block, then a MoE
                     # block, per step: llama4's "interleave:2") | ssd |
                     # rg3 (one cfg.rglru.pattern a step) | rg_tail |
                     # encoder | decoder (enc-dec) | vision_pattern (a
                     # cross block, then cross_attn_every - 1 self blocks)
    n: int           # stacked layers (dense_moe: pairs; rg3 and
                     # vision_pattern: patterns)
    window: int = 0  # sliding window of the attention blocks (0 = full)


# the blocks of one dense_moe step, in order: each has its own subtree of
# the segment's parameters and caches
PAIR = ("dense", "moe")
# a cache's slot-resident leaves beside the segments' (both layouts): the
# enc-dec or vision memory, the MTP hidden and ring
AUX = ("memory", "mtp_h", "mtp")


def _segments(cfg: ModelConfig) -> List[Segment]:
    L = cfg.num_layers
    if cfg.family == "dense":
        return [Segment("blocks", "dense", L)]
    if cfg.family == "moe":
        lay = cfg.moe.layout
        if lay == "all":
            return [Segment("blocks", "moe", L)]
        if lay.startswith("dense_first:"):
            n0 = int(lay.split(":")[1])
            return [Segment("dense0", "dense", n0),
                    Segment("blocks", "moe", L - n0)]
        if lay.startswith("interleave:"):
            k = int(lay.split(":")[1])
            assert k == 2 and L % 2 == 0, (lay, L)
            return [Segment("pat", "dense_moe", L // 2)]
        raise ValueError(lay)
    if cfg.family == "vlm":
        assert L % cfg.cross_attn_every == 0
        return [Segment("pat", "vision_pattern", L // cfg.cross_attn_every)]
    if cfg.family == "encdec":
        return [Segment("dec", "decoder", L)]
    if cfg.family == "ssm":
        return [Segment("blocks", "ssd", L)]
    if cfg.family == "hybrid":
        plen = len(cfg.rglru.pattern)
        segs = [Segment("pat", "rg3", L // plen, window=cfg.rglru.window)]
        if L % plen:
            segs.append(Segment("tail", "rg_tail", 1))
        return segs
    raise ValueError(cfg.family)


def _encoder(cfg: ModelConfig) -> Segment:
    """The enc-dec family's encoder stack (not among ``Model.segments``:
    it runs once a prompt, over the frame embeddings)."""
    return Segment("enc", "encoder", cfg.encoder_layers)


def _batch_axis(kind: str) -> int:
    """A segment's cache leaves' batch axis: behind the stacked-layers
    axis, and behind the pattern axis too for the vision pattern's nested
    rings."""
    return 2 if kind == "vision_pattern" else 1


def _pages(seg: Segment) -> bool:
    """Whether a segment has a paged layout: non-windowed attention
    caches only. Recurrent state (ssd, rg3, rg_tail), the vision pattern's
    nested rings and windowed rings stay on the dense cache, as in the
    reference."""
    return (seg.kind not in ("ssd", "rg3", "rg_tail", "vision_pattern")
            and not seg.window)


def _rg_tail_len(cfg: ModelConfig) -> int:
    return cfg.num_layers % len(cfg.rglru.pattern)


def _pattern_keys(cfg: ModelConfig, seg: Segment) -> List[Tuple[str, str]]:
    """(subtree key, block kind) of one rg3 / rg_tail step, in order:
    ``r{i}`` recurrent, ``a{i}`` attention (the reference's keys)."""
    if seg.kind == "rg_tail":
        return [(f"r{i}", "recurrent") for i in range(_rg_tail_len(cfg))]
    return [(f"r{i}" if k == "recurrent" else f"a{i}", k)
            for i, k in enumerate(cfg.rglru.pattern)]


def per_block(seg: Segment, fn, *trees):
    """``fn`` over the segment's block subtrees: once on ``trees`` for a
    dense or MoE segment, per block of :data:`PAIR` on a dense_moe one
    (``{"dense": fn(...), "moe": fn(...)}``, as the reference nests
    them)."""
    if seg.kind == "dense_moe":
        return {k: fn(*(t[k] for t in trees)) for k in PAIR}
    return fn(*trees)


def step_phases(seg: Segment, p, x, cfg: ModelConfig, ctx: dict, cache):
    """One step of a segment as phases (``collectives.drive``): one block,
    a dense_moe pair's dense block then its MoE block, one SSD block, or
    an rg3 / rg_tail step's blocks in ``cfg.rglru.pattern`` order (the
    reference's ``_apply_kind``; a windowed segment's attention is local),
    one encoder or enc-dec decoder block, or a vision pattern's cross
    block then its self blocks. Returns (x, cache_out, stats); a pair's or
    a pattern's cache out is per block (a vision pattern's ``{"selfs":
    [per self block]}``), and a pair's stats are the MoE block's. The
    recurrent, encoder, decoder and cross blocks issue no collective:
    they run through."""
    if seg.window:
        ctx = dict(ctx, window=seg.window)
    if seg.kind == "ssd":
        return ssm_mod.ssd_block_apply(p, x, cfg, ctx, cache)
    if seg.kind == "encoder":
        return tfm.encoder_block_apply(p, x, cfg, ctx, cache)
    if seg.kind == "decoder":
        return tfm.decoder_block_apply(p, x, cfg, ctx, cache)
    if seg.kind == "vision_pattern":
        x, _, _ = tfm.cross_block_apply(p["cross"], x, cfg, ctx)
        outs = []
        for j in range(cfg.cross_attn_every - 1):
            c = None if cache is None else layer(cache["selfs"], j)
            x, out, _ = yield from tfm.block_phases(
                layer(p["selfs"], j), x, cfg, ctx, c)
            outs.append(out)
        return x, {"selfs": outs}, {}
    if seg.kind in ("rg3", "rg_tail"):
        outs = {}
        for key, kind in _pattern_keys(cfg, seg):
            c = None if cache is None else cache[key]
            if kind == "recurrent":
                x, outs[key], _ = rg_mod.recurrent_block_apply(
                    p[key], x, cfg, ctx, c)
            else:
                x, outs[key], _ = yield from tfm.block_phases(
                    p[key], x, cfg, ctx, c)
        return x, outs, {}
    if seg.kind != "dense_moe":
        return (yield from tfm.block_phases(p, x, cfg, ctx, cache))
    outs, st = {}, {}
    for k in PAIR:
        x, outs[k], st = yield from tfm.block_phases(
            p[k], x, cfg, ctx, None if cache is None else cache[k])
    return x, outs, st


def _kind_specs(cfg: ModelConfig, seg: Segment) -> dict:
    if seg.kind in ("dense", "encoder"):
        return tfm.dense_block_specs(cfg, seg.n)
    if seg.kind == "decoder":
        return tfm.decoder_block_specs(cfg, seg.n)
    if seg.kind == "vision_pattern":
        return {"cross": tfm.cross_block_specs(cfg, seg.n),
                "selfs": tfm.dense_block_specs(
                    cfg, (seg.n, cfg.cross_attn_every - 1))}
    if seg.kind == "moe":
        return tfm.moe_block_specs(cfg, seg.n)
    if seg.kind == "ssd":
        return ssm_mod.ssd_block_specs(cfg, seg.n)
    if seg.kind in ("rg3", "rg_tail"):
        return {key: (rg_mod.recurrent_block_specs(cfg, seg.n)
                      if kind == "recurrent"
                      else tfm.dense_block_specs(cfg, seg.n))
                for key, kind in _pattern_keys(cfg, seg)}
    return {"dense": tfm.dense_block_specs(cfg, seg.n),
            "moe": tfm.moe_block_specs(cfg, seg.n)}


def _embed_specs(cfg: ModelConfig) -> dict:
    d, V, pd = cfg.d_model, cfg.vocab_size, cfg.param_dtype
    specs = {
        "emb": ParamSpec((V, d), pd, ("vocab", "embed"), "normal"),
        "final_norm": ParamSpec((d,), pd, (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        specs["unemb"] = ParamSpec((d, V), pd, ("embed", "vocab"), "fan_in")
    return specs


def _kind_cache(cfg: ModelConfig, seg: Segment, batch: int, max_len: int,
                device) -> dict:
    if seg.kind == "ssd":
        return ssm_mod.init_ssd_cache(cfg, seg.n, batch, device)
    if seg.kind in ("rg3", "rg_tail"):
        return {key: (rg_mod.init_rglru_cache(cfg, seg.n, batch, device)
                      if kind == "recurrent"
                      else Lyr.init_gqa_cache(cfg, seg.n, batch, max_len,
                                              device, window=seg.window))
                for key, kind in _pattern_keys(cfg, seg)}
    if seg.kind == "dense_moe":
        return {k: Lyr.init_gqa_cache(cfg, seg.n, batch, max_len, device)
                for k in PAIR}
    if seg.kind == "vision_pattern":
        # the pattern's self blocks' rings, (n, k, batch, max_len, ...):
        # one more stacked axis, so batch on axis 2
        k = cfg.cross_attn_every - 1
        return {"selfs": {name: t.view(seg.n, k, *t.shape[1:])
                          for name, t in Lyr.init_gqa_cache(
                              cfg, seg.n * k, batch, max_len,
                              device).items()}}
    if cfg.attention == "mla":
        return mla_mod.init_mla_cache(cfg, seg.n, batch, max_len, device)
    return Lyr.init_gqa_cache(cfg, seg.n, batch, max_len, device)


def _kind_paged_cache(cfg: ModelConfig, seg: Segment, pool_pages: int,
                      page_size: int, storage: str, device) -> dict:
    """Paged pool for one segment (attention caches only). Recurrent state
    and windowed rings have no paged layout: asking for one is a config
    error (the reference's ``ValueError``), not a silent fallback."""
    if not _pages(seg):
        raise ValueError(
            f"segment {seg.name!r} (kind={seg.kind!r}, window={seg.window})"
            " has no paged layout: only non-windowed attention caches page "
            "— recurrent SSM/RG-LRU state stays slot-resident at full "
            "precision and windowed rings are dense-only. Use the "
            "dense-cache engine for this arch.")
    if seg.kind == "dense_moe":
        return {k: Lyr.init_paged_gqa_cache(cfg, seg.n, pool_pages,
                                            page_size, storage, device)
                for k in PAIR}
    init = (mla_mod.init_paged_mla_cache if cfg.attention == "mla"
            else Lyr.init_paged_gqa_cache)
    return init(cfg, seg.n, pool_pages, page_size, storage, device)


def _under_pctx(fn):
    """A Model entry point run under the mesh ctx of its ``pctx=`` keyword
    (none given: the current one)."""
    @functools.wraps(fn)
    def run(self, *args, pctx=None, **kwargs):
        with pctx_mod.use(pctx):
            return fn(self, *args, **kwargs)
    return run


# the products whose outputs ``remat="dots"`` saves: matrix products with
# no batch dimension (a linear's ``matmul`` of (..., K) by (K, N) reaches
# the dispatcher as ``mm``; batched products, the attention's and the
# experts' ``bmm``, are recomputed), as the reference's
# ``dots_with_no_batch_dims_saveable``
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(step, policy: str, tag: Optional[str] = None):
    """``step`` under the ctx's remat policy (the reference's
    ``apply_remat``; the one wrapper of the single backbone and the dual
    microbatch's layers). ``full``: ``torch.utils.checkpoint`` (non-reentrant)
    keeps the step's inputs and recomputes its forward in the backward;
    ``dots``: a selective checkpoint that also keeps the outputs of the
    ``mm``/``addmm`` products (:data:`_DOTS`) and recomputes the rest;
    ``none``, or without autograd: ``step`` itself. The recompute runs
    under the forward's parallel ctx, sequence cut and collective tag
    ``tag``, so it issues what the forward issued. Remat changes memory and
    recompute, never a value."""
    def tagged(*args):
        with coll.tagged(tag):
            return step(*args)
    if policy == "none" or not torch.is_grad_enabled():
        return tagged
    from torch.utils import checkpoint as ckpt
    c = pctx_mod.get()

    def scoped(*args):
        with pctx_mod.use(c):
            return tagged(*args)

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: ckpt.checkpoint(scoped, *args, use_reentrant=False,
                                         **kw)


def stack_stats(stats: List[dict]) -> Dict[str, torch.Tensor]:
    """Per-layer MoE stats stacked over a segment's layers, as the
    reference's scan stacks them (``load`` (n, E)); {} where none."""
    if not stats or not stats[0]:
        return {}
    return {k: torch.stack([st[k] for st in stats]) for k in stats[0]}


def _advance(st: dict, logits: torch.Tensor, temperature: float,
             top_k: int):
    """One decode step's sampling and state update from the step's logits
    (B, 1, V): the sampled tokens, the emitted tokens (-1 where a slot was
    inactive) and the new state (EOS and budget masks applied)."""
    tok, active, eos = st["tokens"], st["active"], st["eos"]
    nxt = sample_logits(logits[:, 0], st["seeds"], st["tix"], temperature,
                        top_k)
    left2 = st["left"] - active.int()
    done = active & (((eos >= 0) & (nxt == eos)) | (left2 <= 0))
    return nxt, torch.where(active, nxt, -1), dict(
        st, tokens=torch.where(active, nxt, tok),
        positions=st["positions"] + active.int(), active=active & ~done,
        left=left2, tix=st["tix"] + active.int())


def _stacked(layer_entries, names) -> Dict[str, torch.Tensor]:
    """Per-layer entry tuples -> ``{name: (n, ...)}``, stacked over the
    layers."""
    return {name: torch.stack([e[i] for e in layer_entries])
            for i, name in enumerate(names)}


def _fill(tree, value):
    """The same nesting of dicts with every leaf replaced by ``value``."""
    if isinstance(tree, dict):
        return {k: _fill(v, value) for k, v in tree.items()}
    return value


# ---------------------------------------------------------------------------
# The Model
# ---------------------------------------------------------------------------


class Model:
    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.segments = _segments(cfg)
        if cfg.family != "ssm":
            tfm.attn_specs(cfg, 1)   # raises for an unknown attention kind
        # attention-impl overrides merged into the serving ctx, e.g.
        # {"gqa_impl": "pallas", "mla_impl": "pallas"} routes paged decode
        # (and GQA prefill) through the kernels
        self.impl_ctx: Dict[str, Any] = {}

    # -- specs / init ------------------------------------------------------
    def specs(self) -> dict:
        cfg = self.cfg
        s: Dict[str, Any] = {"embed": _embed_specs(cfg)}
        for seg in self.segments:
            s[seg.name] = _kind_specs(cfg, seg)
        if cfg.encoder_layers:
            s["enc"] = _kind_specs(cfg, _encoder(cfg))
            s["enc_norm"] = ParamSpec((cfg.d_model,), cfg.param_dtype,
                                      (None,), "ones")
        if cfg.mtp:
            s["mtp"] = mtp_mod.mtp_specs(
                cfg, lambda n: tfm.dense_block_specs(cfg, n, d_ff=cfg.d_ff))
        return s

    def init(self, seed: int = 0):
        return init_params(self.specs(), seed, self.device)

    def param_structs(self):
        """The parameter tree as ``meta`` tensors (global shapes, nothing
        allocated): the reference's ``param_structs``."""
        return param_structs(self.specs())

    def input_specs(self, shape: ShapeCfg) -> Dict[str, Any]:
        """The step's inputs for ``shape`` as ``meta`` tensors, global
        shapes (the reference's ``input_specs``): ``tokens`` (and for
        train ``labels``) (B, S) int32, with ``src_embeds`` or
        ``patch_embeds`` for the families with a memory; for decode
        ``tokens`` and ``positions`` (B, 1) int32 and the dense cache over
        S context rows."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = dict(dtype=torch.int32, device="meta")
        dt = dict(dtype=torch_dtype(cfg.dtype), device="meta")
        if shape.phase in ("train", "prefill"):
            d: Dict[str, Any] = {"tokens": torch.empty((B, S), **i32)}
            if shape.phase == "train":
                d["labels"] = torch.empty((B, S), **i32)
            if cfg.family == "encdec":
                d["src_embeds"] = torch.empty(
                    (B, int(S * cfg.src_len_ratio), cfg.d_model), **dt)
            if cfg.family == "vlm":
                d["patch_embeds"] = torch.empty(
                    (B, cfg.num_patches, cfg.d_model), **dt)
            return d
        return {"tokens": torch.empty((B, 1), **i32),
                "positions": torch.empty((B, 1), **i32),
                "cache": self.init_cache(B, S, device="meta")}

    # -- shared pieces -------------------------------------------------------
    def _embed(self, params, tokens):
        """Token embeddings (B, S, d). Under a sequence cut
        (``parallel/context.seq_group``) this rank's chunk of the
        sequence: the vocab-parallel sum is reduce-scattered along it, or,
        with the table whole on each rank, the lookup takes this rank's
        tokens (the table's gradient then summed over the group)."""
        emb = sharding.gathered(params["embed"], ("embed",))["emb"]
        dt = torch_dtype(self.cfg.dtype)
        sp = pctx_mod.seq_group()
        V = emb.shape[0]
        if V == self.cfg.vocab_size:
            if sp is not None:
                emb = coll.copy_to_group(emb, sp)
                tokens = coll.own_part(tokens, sp, 1)
            return emb[tokens].to(dt)
        # this rank's vocab rows: the lookup is masked to them, and the
        # model group's sum holds every token's one row
        c = pctx_mod.get()
        local = tokens.long() - c.index(c.tp_axis) * V
        inside = (local >= 0) & (local < V)
        e = emb[local.clamp(0, V - 1)].masked_fill(~inside[..., None], 0)
        if sp is not None:
            return coll.scatter_sum(e, sp, 1).to(dt)
        return coll.reduce_sum(e, c.tp_group).to(dt)

    def _unembed(self, params, h):
        """Final norm and logits. Vocab-parallel under a model group: the
        hidden enters through ``copy_to_group``, each rank's vocab columns
        are gathered (``collectives.gather``) and every rank computes the
        CE on the whole logits, so the gather's backward is this rank's
        slice of their gradient (not a vocab-parallel log-sum-exp). Under
        a sequence cut the norm runs on this rank's tokens and the hidden
        is gathered along the sequence in place of ``copy_to_group``."""
        emb = sharding.gathered(params["embed"], ("embed",))
        sp = pctx_mod.seq_group()
        w = emb.get("unemb")
        if w is None:
            w = emb["emb"].T
        whole = w.shape[-1] == self.cfg.vocab_size
        if sp is not None:
            # the norm on this rank's tokens, then the sequence gathered
            h = Lyr.rmsnorm(h, coll.copy_to_group(emb["final_norm"], sp),
                            self.cfg.rms_eps)
            h = coll.gather(h, sp, 1,
                            backward="slice" if whole else "reduce_scatter")
            if whole:
                return torch.matmul(h, w.to(h.dtype))
            logits = torch.matmul(h, w.to(h.dtype))
            return coll.gather(logits, pctx_mod.get().tp_group, dim=-1)
        h = Lyr.rmsnorm(h, emb["final_norm"], self.cfg.rms_eps)
        if whole:
            return torch.matmul(h, w.to(h.dtype))
        group = pctx_mod.get().tp_group
        logits = torch.matmul(coll.copy_to_group(h, group), w.to(h.dtype))
        return coll.gather(logits, group, dim=-1)

    def _ctx(self, params, **kw) -> dict:
        # weights_qdq: expert weights were quant-dequantized at load
        # (bridge.prepare_for_serving) and must not be again
        return dict(kw, weights_qdq=bool(params.get("prepared", False)),
                    **self.impl_ctx)

    def _run_segment(self, seg: Segment, p, x, ctx, cache):
        """The segment's steps in turn (:func:`step_phases`), each under
        the ctx's remat policy (:func:`remat`). Returns (x, per-step
        outputs, stats): each MoE stat stacked over the steps
        (:func:`stack_stats`). Each step's collectives carry its name
        (``collectives.tagged``)."""
        outs, stats = [], []
        policy = pctx_mod.get().remat

        def step(h, pl, c):
            return coll.drive(step_phases(seg, pl, h, self.cfg, ctx, c))

        for i in range(seg.n):
            c = None if cache is None else layer(cache, i)
            x, out, st = remat(step, policy, f"{seg.name}/{i}")(
                x, sharding.gathered(p, (seg.name,), i), c)
            outs.append(out)
            stats.append(st)
        return x, outs, stack_stats(stats)

    def _encode(self, params, src_embeds):
        """The encoder stack over frame embeddings (B, S, d), then its
        norm: the enc-dec family's memory. Its ctx is fresh, as the
        reference's (no ``impl_ctx``): the encoder's attention runs the
        plain path."""
        cfg = self.cfg
        B, S, _ = src_embeds.shape
        pos = torch.arange(S, dtype=torch.int32,
                           device=self.device).expand(B, S)
        x = src_embeds.to(torch_dtype(cfg.dtype))
        x = self._run_segment(_encoder(cfg), params["enc"], x,
                              dict(positions=pos, causal=False), None)[0]
        return Lyr.rmsnorm(x, params["enc_norm"], cfg.rms_eps)

    def _memory_ctx(self, params, ctx, extras) -> dict:
        """``ctx`` with the memory the decoder or cross blocks attend over,
        from ``extras``: the enc-dec family's ``memory`` as it is, or the
        encoder's output over ``src_embeds``; the vision family's
        ``patch_embeds`` in the model dtype. Its key positions are
        ``arange`` over all its rows, as the reference's."""
        cfg = self.cfg
        def on_device(key):      # numpy or torch, dtype kept
            return torch.as_tensor(extras[key], device=self.device)
        if cfg.family == "encdec":
            mem = (on_device("memory") if "memory" in extras
                   else self._encode(params, on_device("src_embeds")))
        elif cfg.family == "vlm":
            mem = on_device("patch_embeds").to(torch_dtype(cfg.dtype))
        else:
            return ctx
        mp = torch.arange(mem.shape[1], dtype=torch.int32,
                          device=self.device).expand(mem.shape[:2])
        return dict(ctx, memory=mem, mem_positions=mp)

    def _backbone(self, params, tokens, ctx, cache):
        """Embed + all segments. Returns (h, per-segment layer outputs,
        per-segment stats). ``ctx`` carries the memory, where the family
        has one (:meth:`_memory_ctx`)."""
        x = self._embed(params, tokens)
        outs, stats = {}, {}
        for seg in self.segments:
            c = cache.get(seg.name) if cache else None
            x, outs[seg.name], st = self._run_segment(
                seg, params[seg.name], x, ctx, c)
            if st:
                stats[seg.name] = st
        return x, outs, stats

    # -- loss (training) -------------------------------------------------------
    def _ce_sum(self, params, h, labels):
        """Summed CE of hidden states against labels (-1 = pad), logits in
        fp32, and the valid-token count. Returns (sum, count)."""
        logits = self._unembed(params, h).float()
        valid = labels >= 0
        lab = torch.where(valid, labels, 0).long()
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, lab[..., None])[..., 0]
        ce = torch.where(valid, lse - ll, 0.0)
        return ce.sum(), valid.sum()

    @staticmethod
    def data_total(v: torch.Tensor) -> torch.Tensor:
        """A count summed over the data axes (no gradient): under a mesh
        each data rank holds its own batch rows, and the CE and MTP means
        are over the global batch, as the reference's."""
        g = pctx_mod.get().dp_group
        return v if g is None else coll.all_reduce(v.detach(), g)

    @staticmethod
    def data_sum(x: torch.Tensor) -> torch.Tensor:
        """The data ranks' parts of the loss summed (``reduce_sum``): the
        value is the global loss on every rank, the gradient this rank's
        part's, so the data-axis reduction of the gradients sums them."""
        return coll.reduce_sum(x, pctx_mod.get().dp_group)

    def loss(self, params, batch):
        """Teacher-forcing loss (the reference's ``Model.loss``): CE, plus
        the MTP loss on an MTP config. Differentiable: the training path.
        Returns ``(loss, metrics)``: ``ce``, ``ntokens``, ``aux_loss``
        (diagnostic, not in the loss), per MoE segment ``<seg>/drop_frac``
        and ``<seg>/load_layers`` (n, E), and ``mtp_loss``.

        Takes the raw weights (no ``prepare_for_serving``) and reads no
        ``impl_ctx``: attention runs on the plain path, as the reference's
        training does; the FP8 linears follow ``cfg.fp8_impl``.

        Under a mesh ctx ``batch`` is this data rank's rows and ``params``
        this rank's shards (gathered by the ctx's ZeRO-3 plan,
        ``sharding.Zero3``, where they are cut over ``data``); the means are over the global batch
        (:meth:`data_total`) and the loss and its metrics are the global
        ones on every rank (:meth:`data_sum`)."""
        if params.get("prepared"):
            raise ValueError("Model.loss takes the raw weights, not a tree "
                             "made by bridge.prepare_for_serving")
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        B, S = tokens.shape
        pos = torch.arange(S, dtype=torch.int32,
                           device=self.device).expand(B, S)
        ctx = self._memory_ctx(params, dict(positions=pos, stats=True), batch)
        with pctx_mod.sequence_sharded(
                pctx_mod.seq_divides(pctx_mod.get(), S)):
            h, _, stats = self._backbone(params, tokens, ctx, None)
            s, n = self._ce_sum(params, h, labels)
        ntok = self.data_total(n).clamp_min(1)
        loss = s / ntok
        metrics: Dict[str, Any] = {"ce": self.data_sum(loss.detach()),
                                   "ntokens": ntok}
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for segname, st in stats.items():
            aux = aux + st["aux_loss"].mean()
            metrics[f"{segname}/drop_frac"] = st["drop"].mean()
            metrics[f"{segname}/load_layers"] = st["load"]
        metrics["aux_loss"] = aux
        if cfg.mtp:
            with pctx_mod.sequence_sharded(
                    pctx_mod.seq_divides(pctx_mod.get(), S)):
                mtp_l = self._mtp_loss(params, h, tokens, pos, ctx)
            metrics["mtp_loss"] = self.data_sum(mtp_l.detach())
            loss = loss + mtp_l
        return self.data_sum(loss), metrics

    def _mtp_loss(self, params, h, tokens, pos, ctx):
        """The MTP modules' loss on the backbone's hidden ``h``: this data
        rank's part of the global mean. Under a sequence cut ``h`` is this
        rank's chunk: it is gathered, and the module runs on the whole
        sequence (its inputs pair each position with the next token)."""
        cfg = self.cfg
        c = pctx_mod.get()
        sp = pctx_mod.seq_group()
        if sp is not None:
            h = coll.gather(h, sp, 1, backward="slice")
        with pctx_mod.sequence_sharded(False):
            return mtp_mod.mtp_losses(
                sharding.gathered(params["mtp"], ("mtp",)), h, tokens,
                emb_fn=lambda t: self._embed(params, t),
                unemb_fn=lambda hh: self._unembed(params, hh),
                cfg=cfg, positions=pos,
                block_apply=lambda p, x, positions: tfm.block_apply(
                    p, x, cfg, dict(ctx, positions=positions), None)[0],
                rows=tokens.shape[0] * c.dp_size)

    def loss_dual(self, params, batchA, batchB):
        """The loss over two anti-phase microbatches (paper §2.3.1
        overlap; the reference's ``Model.loss_dual``): each layer runs on
        both before the next, so under a mesh each microbatch's MoE
        all-to-alls are in flight under the other's compute
        (``parallel/overlap.py``). Returns ``(loss, metrics)`` with
        ``loss``'s metrics schema, microbatch-averaged, the CE weighted by
        each half's valid tokens (it equals ``loss`` on the joined batch).
        Under a mesh ctx each half is this data rank's part of it, as in
        :meth:`loss`."""
        if params.get("prepared"):
            raise ValueError("Model.loss_dual takes the raw weights, not a "
                             "tree made by bridge.prepare_for_serving")
        from repro_torch.parallel import overlap
        return overlap.dual_loss_and_metrics(self, params, batchA, batchB)

    # -- prefill ---------------------------------------------------------------
    @torch.no_grad()
    @_under_pctx
    def prefill(self, params, batch, extra_slots: int = 0, lengths=None):
        """Process the prompt; returns (last-position logits (B,1,V),
        cache). ``lengths`` (B,) enables the bucketed path: ``tokens`` is
        right-padded to a static bucket S and only the first
        ``lengths[b]`` positions are real — pads never enter the cache,
        rank below every real token in the MoE capacity contest, and the
        logits are taken at ``lengths-1``. The cache holds each layer's
        rings ``(n, B, S + extra_slots, ...)`` — MLA latents or GQA K/V
        with ``pos`` — and, with MTP, the last hidden ``mtp_h`` and the MTP
        module's ring over the prompt; with a memory (``batch``'s
        ``src_embeds``, ``memory`` or ``patch_embeds``), the ``memory``
        leaf (B, rows, d). At ``extra_slots=0`` it is the input of
        ``prefill_to_pages``; the dense engine splices a ``max_len`` ring.
        ``pctx=``: the mesh ctx to run under (module docstring)."""
        tokens = batch["tokens"].to(self.device)
        B, S = tokens.shape
        pos = torch.arange(S, dtype=torch.int32,
                           device=self.device).expand(B, S)
        # no lengths = every row full: an all-true mask changes neither
        # the MoE ranking nor its capacity, so one path serves both
        lengths = torch.as_tensor(S if lengths is None else lengths,
                                  dtype=torch.int32,
                                  device=self.device).expand(B)
        ctx = self._memory_ctx(params, self._ctx(
            params, positions=pos, collect_cache=True,
            valid=pos < lengths[:, None], prompt_lengths=lengths), batch)
        h, entries, _ = self._backbone(params, tokens, ctx, None)
        idx = (lengths - 1).clamp(0, S - 1).long()
        h_last = h[torch.arange(B, device=self.device), idx][:, None]
        logits = self._unembed(params, h_last)
        T = S + extra_slots
        cache = {seg.name: self._seg_cache(seg, entries[seg.name], S, T,
                                           lengths)
                 for seg in self.segments}
        if "memory" in ctx:
            cache["memory"] = ctx["memory"]
        if self.cfg.mtp:
            cache["mtp_h"] = h_last
            cache["mtp"] = self._mtp_prefill_ring(params, h, tokens, pos, T,
                                                  lengths)
        return logits, cache

    def _seg_cache(self, seg: Segment, step_entries, S: int, T: int,
                   lengths):
        """A segment's cache leaves from its per-step prefill entries (a
        dense_moe or pattern step's are per block). The SSD and RG-LRU
        entries (conv tail, final state) are exact at the prompt's length
        already (the blocks gate the pads out) and are stacked as they
        are; a windowed segment's rings hold ``min(T, window)`` rows."""
        if seg.kind == "dense_moe":
            return {k: self._entries_to_cache([e[k] for e in step_entries],
                                              S, T, lengths)
                    for k in PAIR}
        if seg.kind == "ssd":
            return _stacked(step_entries, ("conv", "state"))
        if seg.kind == "vision_pattern":
            # the self blocks' rings, (n, k, B, T, ...): the reference's
            # ``_vision_cache`` (positions ``arange(S)`` masked past each
            # row's length; rows past S empty)
            k = self.cfg.cross_attn_every - 1
            rings = self._entries_to_cache(
                [b for e in step_entries for b in e["selfs"]], S, T, lengths)
            return {"selfs": {name: t.view(seg.n, k, *t.shape[1:])
                              for name, t in rings.items()}}
        if seg.kind in ("rg3", "rg_tail"):
            return {key: (_stacked([e[key] for e in step_entries],
                                   ("conv", "h"))
                          if kind == "recurrent" else self._entries_to_cache(
                              [e[key] for e in step_entries], S, T, lengths,
                              seg.window))
                    for key, kind in _pattern_keys(self.cfg, seg)}
        return self._entries_to_cache(step_entries, S, T, lengths)

    def _entries_to_cache(self, layer_entries, S: int, T: int, lengths,
                          window: int = 0):
        """Per-layer prefill entries — MLA ``(ckv, kr)`` or GQA ``(k, v)``,
        ``(B, S, ...)`` each — -> ring leaves ``(n, B, Tc, ...)`` in the
        cache dtype with ``pos`` (-1 on empty rows, whose values are
        zeroed); ``Tc = T``, or ``min(T, window)`` under a window. Ring row
        t holds the newest prompt token whose position p satisfies p ≡ t
        (mod Tc): a per-row gather that serves a ring at least as long as
        the prompt and one shorter than it (a window the prompt wraps)."""
        T = min(T, window) if window else T
        cdt = torch_dtype(self.cfg.cache_dtype_())
        names = ("ckv", "kr") if self.cfg.attention == "mla" else ("k", "v")
        leaves = {name: torch.stack([e[i] for e in layer_entries])
                  for i, name in enumerate(names)}
        n, B = leaves[names[0]].shape[:2]
        t = torch.arange(T, dtype=torch.int32, device=self.device)
        n_t = torch.div(lengths[:, None] - 1 - t[None, :], T,
                        rounding_mode="floor")
        src = t[None, :] + n_t * T                           # (B, T)
        valid = (src >= 0) & (src < lengths[:, None])
        srcc = src.clamp(0, S - 1).long()

        def prep(x):
            tail = x.shape[3:]
            idx = srcc.reshape((1, B, T) + (1,) * len(tail)).expand(
                (n, B, T) + tail)
            m = valid.reshape((1, B, T) + (1,) * len(tail))
            return torch.gather(x, 2, idx).masked_fill(~m, 0).to(cdt)

        pos = torch.where(valid, src, -1).expand(n, B, T).contiguous()
        return dict({k: prep(x) for k, x in leaves.items()}, pos=pos)

    def _mtp_prefill_ring(self, params, h, tokens, pos, T: int, lengths):
        """Fill MTP module 1's ring over the prompt: the module runs over
        the prompt's ``L-1`` pairs ``(h_k, Emb(t_{k+1}))`` (positions
        ``0..L-2``), as in training, and its block's cache entries become a
        length-``T`` ring. Position ``L-1``'s pair needs the first
        generated token; the first decode step's draft writes it."""
        cfg = self.cfg
        B, S = tokens.shape
        if S == 1:                 # single-token prompt: no pairs
            return self._init_mtp_ring(B, T)
        Sm = S - 1
        pair_pos = pos[:, :Sm]
        # pair k exists iff t_{k+1} is a real prompt token: k < L-1
        pair_valid = pair_pos < (lengths[:, None] - 1)
        entries = {}

        def bapply(pb, x, p_):
            out, entries["e"], _ = tfm.block_apply(
                pb, x, cfg, dict(positions=p_, collect_cache=True,
                                 valid=pair_valid), None)
            return out

        mtp_mod.mtp_hidden(layer(sharding.gathered(params["mtp"], ("mtp",)),
                                 0), h[:, :Sm],
                           self._embed(params, tokens[:, 1:]), cfg=cfg,
                           positions=pair_pos, block_apply=bapply)
        cdt = torch_dtype(cfg.cache_dtype_())

        def ring(x):
            m = pair_valid.reshape((B, Sm) + (1,) * (x.dim() - 2))
            buf = torch.zeros((B, T) + x.shape[2:], dtype=cdt,
                              device=self.device)
            buf[:, :Sm] = x.masked_fill(~m, 0).to(cdt)
            return buf[None]

        rpos = torch.full((1, B, T), -1, dtype=torch.int32,
                          device=self.device)
        rpos[0, :, :Sm] = torch.where(pair_valid, pair_pos, -1)
        a, b = entries["e"]
        names = ("ckv", "kr") if cfg.attention == "mla" else ("k", "v")
        return {names[0]: ring(a), names[1]: ring(b), "pos": rpos}

    # -- decode ----------------------------------------------------------------
    @torch.no_grad()
    @_under_pctx
    def decode_step(self, params, cache, tokens, positions,
                    batch_sharded: bool = False):
        """One decode step over the dense rings or the paged cache (written
        in place); a paged cache carries its ``page_table``. tokens,
        positions: (B, 1) int32. With MTP the step's hidden is copied into
        ``cache['mtp_h']``, the next draft's input: every leaf of the cache
        stays the tensor it was, so a captured decode chunk reads and
        writes the same buffers at each replay. ``batch_sharded``: the
        B slots are this data row's share of a page table over every
        slot; ``pctx=``, the mesh ctx. Returns (logits (B,1,V), cache)."""
        ctx = self._ctx(params, positions=positions,
                        batch_sharded=batch_sharded)
        if "page_table" in cache:
            table = ctx["page_table"] = cache["page_table"]
            B = tokens.shape[0]
            if table.shape[0] != B:
                c = pctx_mod.get()
                d, g = c.dp_index, c.dp_group
                ctx["page_table"] = table[d * B:(d + 1) * B]
                ctx["dp_write"] = (g, table,
                                   coll.all_gather(positions[:, 0], g))
        if "memory" in cache:
            # the memory leaf, as the reference reads it back: the enc-dec
            # family's as it is, the vision family's as patch embeddings
            key = "patch_embeds" if self.cfg.family == "vlm" else "memory"
            ctx = self._memory_ctx(params, ctx, {key: cache["memory"]})
        h, _, _ = self._backbone(params, tokens, ctx, cache)
        if self.cfg.mtp:
            cache["mtp_h"].copy_(h)
        return self._unembed(params, h), cache

    def init_decode_state(self, batch: int) -> Dict[str, torch.Tensor]:
        """Per-slot decode state consumed by ``decode_loop``: last token and
        its next position, occupancy, decode budget, EOS id (-1 = none),
        the request's sampling seed and the next stream index; and the
        chunk's MTP counters (drafts made, drafts accepted)."""
        i32 = dict(dtype=torch.int32, device=self.device)
        return dict(
            tokens=torch.zeros(batch, **i32),
            positions=torch.zeros(batch, **i32),
            active=torch.zeros(batch, dtype=torch.bool, device=self.device),
            left=torch.zeros(batch, **i32),
            eos=torch.full((batch,), -1, **i32),
            seeds=torch.zeros(batch, dtype=torch.int64, device=self.device),
            tix=torch.zeros(batch, **i32),
            drafts=torch.zeros((), **i32),
            accepted=torch.zeros((), **i32),
        )

    @torch.no_grad()
    @_under_pctx
    def decode_loop(self, params, cache, state, k: int, *,
                    temperature: float = 0.0, top_k: int = 0,
                    use_mtp: bool = False, overlap: bool = False,
                    batch_sharded: bool = False):
        """``k`` decode steps with sampling, EOS and budget masking on the
        card. With ``use_mtp`` each step first drafts from the carried pair
        ``(mtp_h, token)`` against the MTP ring (``core/mtp.py``), then
        verifies the draft against the token the step samples; ``drafts``
        and ``accepted`` in the state count active steps and hits. Returns
        ``(tokens (B,k), emitted (B,k) bool, cache, state)``; tokens are -1
        where the slot was inactive. ``pctx=`` and ``batch_sharded``: as
        :meth:`decode_step`'s.

        ``overlap=True`` runs the batch as two anti-phase half-batches,
        layer by layer (``parallel/overlap.dual_decode_step``), so that
        under a mesh each half's MoE all-to-alls are in flight while the
        other half computes: the paper's §2.3.1 dual microbatch applied
        to decode. Dense caches only (a paged pool is shared by the
        slots), no MTP, an even batch."""
        if overlap:
            if use_mtp:
                raise ValueError("decode overlap is incompatible with "
                                 "use_mtp: the draft ring is not split")
            return self._decode_loop_dual(
                params, cache, state, k, temperature=temperature,
                top_k=top_k, batch_sharded=batch_sharded)
        if use_mtp and not self.cfg.mtp:
            raise ValueError(f"use_mtp: {self.cfg.name} has no MTP module")
        st = dict(state)
        toks, was_active = [], []
        for _ in range(k):
            tok, pos, active = st["tokens"], st["positions"], st["active"]
            if use_mtp:
                draft = mtp_mod.mtp_draft_tokens(
                    params, cache, self.cfg, tok, pos,
                    embed_fn=lambda t: self._embed(params, t),
                    unembed_fn=lambda hh: self._unembed(params, hh))
            logits, cache = self.decode_step(params, cache, tok[:, None],
                                             pos[:, None],
                                             batch_sharded=batch_sharded)
            nxt, emitted, st2 = _advance(st, logits, temperature, top_k)
            if use_mtp:
                st2["drafts"] = st["drafts"] + active.sum(dtype=torch.int32)
                st2["accepted"] = st["accepted"] + (
                    active & (draft == nxt)).sum(dtype=torch.int32)
            toks.append(emitted)
            was_active.append(active)
            st = st2
        return (torch.stack(toks, dim=1), torch.stack(was_active, dim=1),
                cache, st)

    def _dense_cache_axes(self, cache) -> Dict[str, Any]:
        """The batch axis of each leaf of a dense decode cache in hand
        (``cache_batch_axes`` keyed off the cache itself): 0 for
        ``mtp_h`` and ``memory``, 1 behind the stacked-layers axis for
        every ring, 2 for the vision pattern's nested rings."""
        kinds = {seg.name: seg.kind for seg in self.segments}
        return {key: (0 if key in ("memory", "mtp_h") else _fill(
                    sub, _batch_axis(kinds.get(key, ""))))
                for key, sub in cache.items()}

    def _decode_loop_dual(self, params, cache, state, k: int, *,
                          temperature: float, top_k: int,
                          batch_sharded: bool):
        """:meth:`decode_loop` over two anti-phase half-batches: the cache
        and the state split at the batch axis into views (slots ``[0,
        b)`` and ``[b, 2b)``), each step through
        ``overlap.dual_decode_step``, which writes the rings in place (so
        a captured chunk replays them); the halves' tokens and state are
        joined back, slot ``i`` at index ``i``. The streams are those of
        the single path wherever routing is per-token deterministic."""
        from repro_torch.parallel import overlap
        B = state["tokens"].shape[0]
        if B % 2:
            raise ValueError(f"decode overlap needs an even batch, got {B}")
        if "page_table" in cache:
            raise ValueError(
                "decode overlap requires a dense cache: paged page pools "
                "are shared across slots and have no batch axis to split")
        if "memory" in cache:
            raise ValueError("decode overlap supports decoder-only "
                             "caches (enc/vlm memory is not threaded "
                             "through the dual step)")
        b = B // 2
        halves = overlap.cache_halves(self, cache)
        sts = [{kk: (v[i * b:(i + 1) * b] if v.dim() else v)
                for kk, v in state.items()} for i in range(2)]
        toks, was_active = [[], []], [[], []]
        for _ in range(k):
            la, lb, _, _ = overlap.dual_decode_step(
                self, params, halves[0], halves[1],
                sts[0]["tokens"][:, None], sts[1]["tokens"][:, None],
                sts[0]["positions"][:, None], sts[1]["positions"][:, None],
                batch_sharded=batch_sharded)
            for i, logits in enumerate((la, lb)):
                was_active[i].append(sts[i]["active"])
                _, emitted, sts[i] = _advance(sts[i], logits, temperature,
                                              top_k)
                toks[i].append(emitted)
        joined = {kk: (torch.cat([sts[0][kk], sts[1][kk]]) if v.dim() else
                       sts[0][kk]) for kk, v in state.items()}
        return (torch.cat([torch.stack(toks[i], dim=1) for i in range(2)]),
                torch.cat([torch.stack(was_active[i], dim=1)
                           for i in range(2)]), cache, joined)

    # -- dense cache family (per-slot rings) ---------------------------------
    def _init_mtp_ring(self, batch: int, max_len: int, device=None) -> dict:
        """MTP module 1's own 1-layer dense ring (its block attends over the
        pair sequence; slot-resident in both cache layouts)."""
        dev = self.device if device is None else device
        return _kind_cache(self.cfg, Segment("mtp", "dense", 1), batch,
                           max_len, dev)

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        """Dense decode cache: per segment a ring ``(n, batch, max_len,
        ...)`` with ``pos``; with MTP also ``mtp_h`` (batch, 1, d) and the
        MTP ring. ``device`` defaults to the model's."""
        dev = self.device if device is None else device
        cfg = self.cfg
        cache: Dict[str, Any] = {
            seg.name: _kind_cache(cfg, seg, batch, max_len, dev)
            for seg in self.segments}
        cache.update(self._memory_leaf(batch, max_len, dev))
        if cfg.mtp:
            cache.update(self._mtp_leaves(batch, max_len, dev))
        return cache

    def _memory_leaf(self, batch: int, max_len: int, device) -> dict:
        """The slot-resident memory of either cache layout, zeros (batch,
        rows, d): ``int(max_len * src_len_ratio)`` rows for the enc-dec
        family, ``num_patches`` for the vision family; {} for the others.
        A request with fewer frames is zero-padded into it at admission,
        and decode attends over every row, as the reference's."""
        cfg = self.cfg
        if cfg.family not in ("encdec", "vlm"):
            return {}
        n = (int(max_len * cfg.src_len_ratio) if cfg.family == "encdec"
             else cfg.num_patches)
        return {"memory": torch.zeros((batch, n, cfg.d_model),
                                      dtype=torch_dtype(cfg.dtype),
                                      device=device)}

    def _mtp_leaves(self, batch: int, max_len: int, device) -> dict:
        """The slot-resident MTP state of either cache layout: the carried
        hidden ``mtp_h`` (batch, 1, d) and the module's ring."""
        return dict(mtp_h=torch.zeros((batch, 1, self.cfg.d_model),
                                      dtype=torch_dtype(self.cfg.dtype),
                                      device=device),
                    mtp=self._init_mtp_ring(batch, max_len, device))

    def cache_batch_axes(self, batch: int, max_len: int) -> Dict[str, Any]:
        """Tree matching ``init_cache`` of each leaf's batch-axis index:
        axis 1 behind the stacked-layers axis for every ring (the MTP
        ring included), axis 2 for the vision pattern's nested rings,
        axis 0 for ``memory`` and ``mtp_h``. Used by the engine's slot
        admission splice."""
        structs = self.init_cache(batch, max_len, device="meta")
        axes = {seg.name: _fill(structs[seg.name], _batch_axis(seg.kind))
                for seg in self.segments}
        if "memory" in structs:
            axes["memory"] = 0
        if "mtp_h" in structs:
            axes["mtp_h"] = 0
            axes["mtp"] = _fill(structs["mtp"], 1)
        return axes

    # -- paged cache family (block pool + page tables; core/paged.py) -------
    def supports_paged(self) -> bool:
        """True iff every segment has a paged layout (non-windowed
        attention). The recurrent and windowed families are dense-cache
        only."""
        return all(_pages(seg) for seg in self.segments)

    def init_paged_cache(self, batch: int, max_len: int, page_size: int,
                         pool_pages: int, storage: str = "fp8", device=None):
        """Shared page pools (``pool_pages`` + 1 trash page per segment, no
        batch axis; MLA latent or GQA K/V pools per the config) and
        ``page_table`` (B, max_len // page_size), trash where unmapped;
        the slot-resident ``memory`` and MTP leaves beside them.
        ``device`` defaults to the model's."""
        dev = self.device if device is None else device
        paged_mod.validate_storage(storage)
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} not a multiple of "
                             f"page_size {page_size}")
        cache: Dict[str, Any] = {
            "page_table": torch.full((batch, max_len // page_size),
                                     paged_mod.trash_page(pool_pages),
                                     dtype=torch.int32, device=dev)}
        for seg in self.segments:
            cache[seg.name] = _kind_paged_cache(self.cfg, seg, pool_pages,
                                                page_size, storage, dev)
        cache.update(self._memory_leaf(batch, max_len, dev))
        if self.cfg.mtp:
            cache.update(self._mtp_leaves(batch, max_len, dev))
        return cache

    def paged_aux_axes(self) -> Dict[str, Any]:
        """Batch axes of a paged cache's slot-resident leaves (the memory,
        the MTP hidden and ring), which admission splices densely."""
        return {k: v for k, v in self.cache_batch_axes(1, 8).items()
                if k in AUX}

    @_under_pctx
    def prefill_to_pages(self, cache1, page_size: int, storage: str):
        """Quantize a batch-1 prefill cache (``extra_slots=0``) into page
        payload ``{"pages": {segment: {leaf: (n, bucket//page, page,
        ...)}}, "aux": {...}}`` (fp8: E4M3 values + per-token scales; a GQA
        token's scale covers its whole ``(KV, hd)`` entry). ``aux`` carries
        the slot-resident leaves as they are (memory, MTP hidden and
        ring). Under
        a KV-head cut (``pctx=``) each token's scale is the model group's
        max over its whole entry."""
        store = torch_dtype(self.cfg.cache_dtype_())

        def seg_pages(sub):
            out = {}
            for name in ("ckv", "kr", "k", "v"):
                if name not in sub:
                    continue
                leaf = sub[name]
                vnd, reduce = 1, None
                if name in ("k", "v"):
                    vnd = 2
                    reduce = Lyr.kv_amax_reduce(leaf.shape[-2], self.cfg)
                d = paged_mod.entries_to_pages(leaf, page_size, storage,
                                               store, vnd, reduce)
                out[name] = d["q"]
                if "scale" in d:
                    out[name + "_scale"] = d["scale"]
            return out

        pages = {seg.name: per_block(seg, seg_pages, cache1[seg.name])
                 for seg in self.segments}
        aux = {k: cache1[k] for k in AUX if k in cache1}
        return {"pages": pages, "aux": aux}

    def install_pages(self, cache, payload_pages, ids):
        """Scatter page payload into the pools at physical ``ids``, in
        place (trash-padded ids land in the scratch page)."""
        ids = torch.as_tensor(ids, device=self.device)

        def seg_scatter(pool, pages):
            for k, pg in pages.items():
                paged_mod.scatter_pages(pool[k], pg, ids)

        for seg in self.segments:
            per_block(seg, seg_scatter, cache[seg.name],
                      payload_pages[seg.name])
        return cache

    def gather_pages(self, cache, ids):
        """Read physical pages ``ids`` out of every pool — the inverse of
        :meth:`install_pages`, ``(layers, len(ids), page, ...)`` per leaf,
        in new tensors (no cache leaf is touched). The device side of a
        tier spill: the caller stages the result to host memory."""
        ids = torch.as_tensor(ids, device=self.device).long()
        return {seg.name: per_block(
                    seg, lambda pools: {k: pool[:, ids]
                                        for k, pool in pools.items()},
                    cache[seg.name])
                for seg in self.segments}

    def admit_pages(self, cache, payload_pages, ids, table_row, slot: int):
        """Scatter a request's prefill pages and install its page-table
        row."""
        self.install_pages(cache, payload_pages, ids)
        cache["page_table"][slot] = torch.as_tensor(
            table_row, dtype=torch.int32, device=self.device)
        return cache

    @torch.no_grad()
    @_under_pctx
    def prefill_chunk(self, params, cache, tokens, positions, lengths, row,
                      slot):
        """One chunk of one slot's prompt against the paged cache: the
        chunked-prefill entry point of the scheduler.

        The chunk writes its K/V (MLA latents) into the slot's pages first,
        then attends over the gathered pages with per-query positional
        validity (``l <= qpos_i``), which covers the resident prefix and
        intra-chunk causality in one path, so every chunk of every prompt
        and slot runs the same shapes. tokens, positions: (1, C), C a
        multiple of the page size, positions absolute from a page-aligned
        start; lengths: (1,) the whole prompt's length — positions past
        ``lengths - 1`` are pads, whose writes land beyond the live prefix
        and which ``valid`` drops from the MoE's capacity contest. ``row``
        (1, pages_per_slot) is the slot's page-table row, an operand: the
        cache's own row stays at the trash page until the last chunk, so
        the slot's masked lane in the decode chunks between can never
        write into the pages the prompt streams into. ``slot`` (1,) picks
        the slot's ``mtp_h`` row, a device operand like the others, so one
        CUDA graph serves every slot (``serve/graph.PrefillChunk``).
        ``pctx=``: the mesh ctx, as ``prefill``'s: the chunk is replicated
        over the data rows and cut over the model axis as a whole prompt's
        prefill is (heads, the row- and column-parallel products, the EP
        dispatch of the ``valid`` tokens, the vocab-parallel unembed). The
        cache is written in place, no leaf rebound; on an MTP config
        ``cache["mtp_h"][slot]`` takes the hidden at ``lengths - 1`` (the
        decode graph reads that leaf). No value is read back to the host.
        Returns ``(logits (1, 1, V) at the chunk's last real position,
        cache)``; only the last chunk's logits (position ``lengths - 1``)
        are meaningful to sample from."""
        dev = self.device
        tokens = torch.as_tensor(tokens, device=dev)
        positions = torch.as_tensor(positions, dtype=torch.int32, device=dev)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        table = torch.as_tensor(row, dtype=torch.int32, device=dev)
        slot = torch.as_tensor(slot, device=dev).reshape(1).long()
        B, C = tokens.shape
        # the reference's ctx also carries ``causal`` (read by its
        # transformer block to pick causal attention) and
        # ``prompt_lengths`` (read by the SSM and RG-LRU blocks when they
        # collect a cache, which a chunk does not: those families have no
        # paged layout); paged attention is causal by position, and
        # ``valid`` brings the length to the MoE
        ctx = self._ctx(params, positions=positions, page_table=table,
                        valid=positions < lengths[:, None])
        h, _, _ = self._backbone(params, tokens, ctx, cache)
        idx = (lengths - 1 - positions[:, 0]).clamp(0, C - 1).long()
        h_last = h[torch.arange(B, device=dev), idx][:, None]
        if self.cfg.mtp:
            # the last chunk's value is h at lengths - 1 (chunked prefill
            # fills no MTP ring: the engine refuses it with use_mtp)
            mtp_h = cache["mtp_h"]
            mtp_h.index_copy_(0, slot, h_last.to(mtp_h.dtype))
        return self._unembed(params, h_last), cache

    def release_slot_pages(self, cache, slot: int):
        """Point a freed slot's row at the trash page, so its masked
        decode lane can never write into pages recycled to a new owner."""
        pool = paged_mod.payload_leaves(cache[self.segments[0].name])[0]
        cache["page_table"][slot] = pool.shape[1] - 1
        return cache


# ---------------------------------------------------------------------------
# Param counting (the reference's convention: MODEL_FLOPS = 6·N·D)
# ---------------------------------------------------------------------------


def _spec_leaves(tree):
    if isinstance(tree, ParamSpec):
        return [tree]
    return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg`` from its specs (nothing allocated; the
    embedding counted once, the unembedding beside it). ``active_only``:
    each routed-expert stack counts ``top_k / num_experts`` of itself, as
    the reference rounds it."""
    total = 0
    for s in _spec_leaves(Model(cfg, device="meta").specs()):
        sz = math.prod(s.shape)
        if active_only and "experts" in s.axes:
            sz = int(sz * cfg.moe.top_k / cfg.moe.num_experts)
        total += sz
    return total

