"""Model API — port of the transformer ``Model`` of ``repro.models.api``
for the paged serving path, MLA (DeepSeek-V3) and GQA (qwen3-14b).

    specs() / init(seed)           ParamSpec dict (the reference's key
                                   names) and materialized tensors
    prefill(params, batch, lengths=)  (last-position logits, cache); the
                                   bucketed form pad-masks the prompt
    init_paged_cache(...)          shared page pools + per-slot page tables
    prefill_to_pages / install_pages / admit_pages / release_slot_pages
    decode_step(params, cache, tokens, positions)
    decode_loop(params, cache, state, k)  k decode steps with on-device
                                   sampling and EOS/budget masks

Layers are stored stacked per segment (``(n, ...)`` leaves, as in the
reference); the port walks them with a Python loop where the reference
scans. PyTorch runs eagerly, so ``decode_loop`` is a loop of ``k`` steps
whose state stays on the card: the host reads it once per chunk.

Sampling: greedy is exact argmax. ``temperature > 0`` draws with the
port's own counter-based generator keyed by ``(request seed, stream
index)`` — the reference's invariant (a token's draw depends only on its
request and its index in the stream, whatever slot or replica runs it),
not its bits (the reference uses threefry).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mla as mla_mod
from repro_torch.core import paged as paged_mod
from repro_torch.core.fp8 import Fp8Weight
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import layers as Lyr
from repro_torch.models import transformer as tfm
from repro_torch.models.param import ParamSpec, init_params

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
    kind: str        # dense | moe
    n: int           # stacked layers


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
    raise NotImplementedError(
        f"family={cfg.family!r} / layout: the port runs the dense and "
        "dense_first/all MoE transformers so far (ROADMAP.md, A.10)")


def _kind_specs(cfg: ModelConfig, seg: Segment) -> dict:
    if seg.kind == "dense":
        return tfm.dense_block_specs(cfg, seg.n)
    return tfm.moe_block_specs(cfg, seg.n)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (tensors, Fp8Weights): views, so a
    pool slice written in place writes the stacked pool."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, Fp8Weight):
        return tree.layer(i)
    return tree[i]


def _embed_specs(cfg: ModelConfig) -> dict:
    d, V, pd = cfg.d_model, cfg.vocab_size, cfg.param_dtype
    specs = {
        "emb": ParamSpec((V, d), pd, ("vocab", "embed"), "normal"),
        "final_norm": ParamSpec((d,), pd, (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        specs["unemb"] = ParamSpec((d, V), pd, ("embed", "vocab"), "fan_in")
    return specs


def _mtp_specs(cfg: ModelConfig) -> dict:
    """MTP module parameters (``repro.core.mtp.mtp_specs``): created and
    carried across so trees match; only the draft path (not ported yet)
    reads them."""
    d, pd = cfg.d_model, cfg.param_dtype
    n = cfg.mtp.num_modules
    return {
        "norm_h": ParamSpec((n, d), pd, ("layers", None), "ones"),
        "norm_e": ParamSpec((n, d), pd, ("layers", None), "ones"),
        "w_proj": ParamSpec((n, 2 * d, d), pd, ("layers", None, "embed"),
                            "fan_in"),
        "block": tfm.dense_block_specs(cfg, n, d_ff=cfg.d_ff),
    }


# ---------------------------------------------------------------------------
# The Model
# ---------------------------------------------------------------------------


class Model:
    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.segments = _segments(cfg)
        tfm.attn_specs(cfg, 1)    # raises for an attention not ported yet
        if cfg.expert_dtype:
            raise NotImplementedError(
                "expert_dtype (fp8 expert storage) is not ported yet "
                "(ROADMAP.md, A.3)")
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
        if cfg.mtp:
            s["mtp"] = _mtp_specs(cfg)
        return s

    def init(self, seed: int = 0):
        return init_params(self.specs(), seed, self.device)

    # -- shared pieces -------------------------------------------------------
    def _embed(self, params, tokens):
        return params["embed"]["emb"][tokens].to(torch_dtype(self.cfg.dtype))

    def _unembed(self, params, h):
        emb = params["embed"]
        h = Lyr.rmsnorm(h, emb["final_norm"], self.cfg.rms_eps)
        w = emb.get("unemb")
        if w is None:
            w = emb["emb"].T
        return torch.matmul(h, w.to(h.dtype))

    def _ctx(self, params, **kw) -> dict:
        # weights_qdq: expert weights were quant-dequantized at load
        # (bridge.prepare_for_serving) and must not be again
        return dict(kw, weights_qdq=bool(params.get("prepared", False)),
                    **self.impl_ctx)

    def _run_segment(self, seg: Segment, p, x, ctx, cache):
        outs = []
        for i in range(seg.n):
            c = None if cache is None else _layer(cache, i)
            x, out = tfm.block_apply(_layer(p, i), x, self.cfg, ctx, c)
            outs.append(out)
        return x, outs

    def _backbone(self, params, tokens, ctx, cache):
        """Embed + all segments. Returns (h, per-segment layer outputs)."""
        x = self._embed(params, tokens)
        outs = {}
        for seg in self.segments:
            c = cache.get(seg.name) if cache else None
            x, outs[seg.name] = self._run_segment(seg, params[seg.name], x,
                                                  ctx, c)
        return x, outs

    # -- prefill ---------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, batch, lengths=None):
        """Process the prompt; returns (last-position logits (B,1,V),
        cache). ``lengths`` (B,) enables the bucketed path: ``tokens`` is
        right-padded to a static bucket S and only the first
        ``lengths[b]`` positions are real — pads never enter the cache,
        rank below every real token in the MoE capacity contest, and the
        logits are taken at ``lengths-1``. The cache holds each layer's
        rows ``(n, B, S, ...)`` — MLA latents or GQA K/V (the reference's
        layout at ``extra_slots=0``, the input of ``prefill_to_pages``)."""
        tokens = batch["tokens"].to(self.device)
        B, S = tokens.shape
        pos = torch.arange(S, dtype=torch.int32,
                           device=self.device).expand(B, S)
        # no lengths = every row full: an all-true mask changes neither
        # the MoE ranking nor its capacity, so one path serves both
        lengths = torch.as_tensor(S if lengths is None else lengths,
                                  dtype=torch.int32,
                                  device=self.device).expand(B)
        ctx = self._ctx(params, positions=pos, collect_cache=True,
                        valid=pos < lengths[:, None])
        h, entries = self._backbone(params, tokens, ctx, None)
        idx = (lengths - 1).clamp(0, S - 1).long()
        h_last = h[torch.arange(B, device=self.device), idx][:, None]
        logits = self._unembed(params, h_last)
        cache = {seg.name: self._entries_to_cache(entries[seg.name], lengths)
                 for seg in self.segments}
        return logits, cache

    def _entries_to_cache(self, layer_entries, lengths):
        """Per-layer prefill entries — MLA ``(ckv, kr)`` or GQA ``(k, v)``
        — -> cache leaves (n, B, S, ...) in the cache dtype, with ``pos``
        (-1 on pad rows, whose values are zeroed)."""
        cdt = torch_dtype(self.cfg.cache_dtype_())
        names = ("ckv", "kr") if self.cfg.attention == "mla" else ("k", "v")
        leaves = {name: torch.stack([e[i] for e in layer_entries])
                  for i, name in enumerate(names)}
        n, B, S = leaves[names[0]].shape[:3]
        t = torch.arange(S, dtype=torch.int32, device=self.device)
        valid = t[None, :] < lengths[:, None]                # (B, S)

        def prep(x):
            m = valid.reshape((1, B, S) + (1,) * (x.dim() - 3))
            return x.masked_fill(~m, 0).to(cdt)

        pos = torch.where(valid, t[None, :], -1).expand(n, B, S)
        return dict({k: prep(x) for k, x in leaves.items()}, pos=pos)

    # -- decode ----------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, params, cache, tokens, positions):
        """One decode step over the paged cache (pools written in place).
        tokens, positions: (B, 1) int32. Returns (logits (B,1,V), cache)."""
        ctx = self._ctx(params, positions=positions,
                        page_table=cache["page_table"])
        h, _ = self._backbone(params, tokens, ctx, cache)
        return self._unembed(params, h), cache

    def init_decode_state(self, batch: int) -> Dict[str, torch.Tensor]:
        """Per-slot decode state consumed by ``decode_loop``: last token and
        its next position, occupancy, decode budget, EOS id (-1 = none),
        the request's sampling seed and the next stream index."""
        i32 = dict(dtype=torch.int32, device=self.device)
        return dict(
            tokens=torch.zeros(batch, **i32),
            positions=torch.zeros(batch, **i32),
            active=torch.zeros(batch, dtype=torch.bool, device=self.device),
            left=torch.zeros(batch, **i32),
            eos=torch.full((batch,), -1, **i32),
            seeds=torch.zeros(batch, dtype=torch.int64, device=self.device),
            tix=torch.zeros(batch, **i32),
        )

    @torch.no_grad()
    def decode_loop(self, params, cache, state, k: int, *,
                    temperature: float = 0.0, top_k: int = 0,
                    use_mtp: bool = False):
        """``k`` decode steps with sampling, EOS and budget masking on the
        card. Returns ``(tokens (B,k), emitted (B,k) bool, cache,
        state)``; tokens are -1 where the slot was inactive."""
        if use_mtp:
            raise NotImplementedError(
                "MTP drafting is not ported yet (ROADMAP.md, A.4)")
        st = dict(state)
        toks, was_active = [], []
        for _ in range(k):
            tok, pos = st["tokens"], st["positions"]
            active, left, eos = st["active"], st["left"], st["eos"]
            logits, cache = self.decode_step(params, cache, tok[:, None],
                                             pos[:, None])
            nxt = sample_logits(logits[:, 0], st["seeds"], st["tix"],
                                temperature, top_k)
            left2 = left - active.int()
            done = active & (((eos >= 0) & (nxt == eos)) | (left2 <= 0))
            toks.append(torch.where(active, nxt, -1))
            was_active.append(active)
            st.update(tokens=torch.where(active, nxt, tok),
                      positions=pos + active.int(), active=active & ~done,
                      left=left2, tix=st["tix"] + active.int())
        return (torch.stack(toks, dim=1), torch.stack(was_active, dim=1),
                cache, st)

    # -- paged cache family (block pool + page tables; core/paged.py) -------
    def init_paged_cache(self, batch: int, max_len: int, page_size: int,
                         pool_pages: int, storage: str = "fp8"):
        """Shared page pools (``pool_pages`` + 1 trash page per segment, no
        batch axis; MLA latent or GQA K/V pools per the config) and
        ``page_table`` (B, max_len // page_size), trash where unmapped."""
        paged_mod.validate_storage(storage)
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} not a multiple of "
                             f"page_size {page_size}")
        cache: Dict[str, Any] = {
            "page_table": torch.full((batch, max_len // page_size),
                                     paged_mod.trash_page(pool_pages),
                                     dtype=torch.int32, device=self.device)}
        init = (mla_mod.init_paged_mla_cache if self.cfg.attention == "mla"
                else Lyr.init_paged_gqa_cache)
        for seg in self.segments:
            cache[seg.name] = init(self.cfg, seg.n, pool_pages, page_size,
                                   storage, self.device)
        return cache

    def prefill_to_pages(self, cache1, page_size: int, storage: str):
        """Quantize a batch-1 prefill cache (``extra_slots=0``) into page
        payload ``{"pages": {segment: {leaf: (n, bucket//page, page,
        ...)}}, "aux": {}}`` (fp8: E4M3 values + per-token scales; a GQA
        token's scale covers its whole ``(KV, hd)`` entry)."""
        store = torch_dtype(self.cfg.cache_dtype_())
        pages: Dict[str, Any] = {}
        for seg in self.segments:
            out = {}
            for name in ("ckv", "kr", "k", "v"):
                if name not in cache1[seg.name]:
                    continue
                vnd = 2 if name in ("k", "v") else 1
                d = paged_mod.entries_to_pages(cache1[seg.name][name],
                                               page_size, storage, store, vnd)
                out[name] = d["q"]
                if "scale" in d:
                    out[name + "_scale"] = d["scale"]
            pages[seg.name] = out
        return {"pages": pages, "aux": {}}

    def install_pages(self, cache, payload_pages, ids):
        """Scatter page payload into the pools at physical ``ids``, in
        place (trash-padded ids land in the scratch page)."""
        ids = torch.as_tensor(ids, device=self.device)
        for seg in self.segments:
            pool = cache[seg.name]
            for k, pages in payload_pages[seg.name].items():
                paged_mod.scatter_pages(pool[k], pages, ids)
        return cache

    def admit_pages(self, cache, payload_pages, ids, table_row, slot: int):
        """Scatter a request's prefill pages and install its page-table
        row."""
        self.install_pages(cache, payload_pages, ids)
        cache["page_table"][slot] = torch.as_tensor(
            table_row, dtype=torch.int32, device=self.device)
        return cache

    def release_slot_pages(self, cache, slot: int):
        """Point a freed slot's row at the trash page, so its masked
        decode lane can never write into pages recycled to a new owner."""
        pool = next(iter(cache[self.segments[0].name].values()))
        cache["page_table"][slot] = pool.shape[1] - 1
        return cache

