"""Analytic FLOP / HBM-byte model per (arch x shape x phase) — the port
of ``repro.launch.costs``, with the H100 SXM's data-sheet peaks.

The counts are analytic: derived from the architecture, term by term, as
documented below, with the reference's arithmetic (the tests hold them
equal to the reference's for every arch and shape). One test calibrates
them against ``torch.utils.flop_counter.FlopCounterMode`` over the port's
``Model.loss`` and its backward on a small config. All quantities are
GLOBAL (divide by device count for per-card roofline terms).

FLOPs:
  GEMM fwd             2 * P_gemm * tokens     (P_gemm = matmul params)
  attention fwd        2 * tokens * kv_len_eff * H * (hd_qk + hd_v)
                       kv_len_eff = S/2 causal, min(window, S) windowed,
                       context length for decode
  backward             2x fwd;  remat=full adds +1x fwd
  q-chunked attention  one extra score recompute in bwd (+1x attn fwd)
  MoE                  experts count with k_active / E fraction
  SSD (mamba-2)        in/out proj GEMMs + chunked scan:
                       2 * tokens * (chunk * (N + P) + N * P) * H

HBM bytes (the memory roofline term):
  weights streamed     P_active_bytes * passes (fwd/bwd/remat)
  optimizer            P * (grad 2B + master r/w 8B + m/v r/w 8B)
  activations          residual stack w+r (2 * L * tokens * d * 2B)
                       + per-layer working set ~ c_act * tokens * d * 2B
  decode               weights once + cache r/w + small vectors
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeCfg

# hardware constants: NVIDIA's data-sheet peaks for the H100 SXM (dense,
# no sparsity), not measurements. The names are the reference's.
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s / card
PEAK_FLOPS_FP8 = 1979e12     # fp8 (E4M3/E5M2) tensor-core FLOP/s / card
PEAK_FLOPS_FP32 = 67e12      # fp32 FLOP/s / card (CUDA cores, no TF32)
HBM_BW = 3.35e12             # HBM3 B/s / card
ICI_BW = 450e9               # NVLink 4 B/s / card, one direction: the
                             # scale-up link inside a node
BYTES_PARAM = 2              # bf16 weights on the wire/HBM


def _attn_dims(cfg: ModelConfig):
    if cfg.attention == "mla":
        m = cfg.mla
        return m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
    hd = cfg.head_dim_()
    return hd, hd


def _layer_counts(cfg: ModelConfig) -> Dict[str, float]:
    """Per-layer-type counts: attention layers, dense-ff, moe-ff, ssd,
    rglru (fractions of num_layers)."""
    L = cfg.num_layers
    out = {"attn": 0.0, "dense_ff": 0.0, "moe_ff": 0.0, "ssd": 0.0,
           "rglru": 0.0, "cross": 0.0}
    if cfg.family in ("dense",):
        out["attn"] = L
        out["dense_ff"] = L
    elif cfg.family == "moe":
        lay = cfg.moe.layout
        out["attn"] = L
        if lay == "all":
            out["moe_ff"] = L
        elif lay.startswith("dense_first:"):
            n0 = int(lay.split(":")[1])
            out["dense_ff"] = n0
            out["moe_ff"] = L - n0
        else:  # interleave:2
            out["dense_ff"] = L / 2
            out["moe_ff"] = L / 2
    elif cfg.family == "vlm":
        k = cfg.cross_attn_every
        out["cross"] = L / k
        out["attn"] = L - L / k
        out["dense_ff"] = L            # every layer has an FFN
    elif cfg.family == "encdec":
        out["attn"] = L + cfg.encoder_layers   # self-attn per layer
        out["cross"] = L                       # decoder cross-attn
        out["dense_ff"] = L + cfg.encoder_layers
    elif cfg.family == "ssm":
        out["ssd"] = L
    elif cfg.family == "hybrid":
        plen = len(cfg.rglru.pattern)
        n_attn = sum(1 for p in cfg.rglru.pattern if p == "attention")
        out["attn"] = L * n_attn / plen
        out["rglru"] = L - L * n_attn / plen
        out["dense_ff"] = L
    return out


def _gemm_params(cfg: ModelConfig) -> Dict[str, float]:
    """Matmul parameters by layer type (per layer), plus unembed."""
    d = cfg.d_model
    hq, hv = _attn_dims(cfg)
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    out: Dict[str, float] = {}
    if cfg.attention == "mla":
        m = cfg.mla
        out["attn"] = (d * m.q_lora_rank + m.q_lora_rank * nh * hq
                       + d * m.kv_lora_rank + d * m.qk_rope_dim
                       + m.kv_lora_rank * nh * (m.qk_nope_dim + m.v_head_dim)
                       + nh * m.v_head_dim * d)
    else:
        hd = cfg.head_dim_()
        out["attn"] = d * hd * (nh + 2 * nkv) + nh * hd * d
    out["cross"] = out.get("attn", 0.0) or (
        d * cfg.head_dim_() * (nh + 2 * nkv) + nh * cfg.head_dim_() * d)
    out["dense_ff"] = 3 * d * cfg.d_ff
    if cfg.moe:
        mc = cfg.moe
        out["moe_ff_active"] = 3 * d * mc.expert_ff * mc.top_k \
            + (3 * d * mc.shared_ff_dim() * mc.num_shared if mc.num_shared
               else 0)
    if cfg.ssm:
        s = cfg.ssm
        d_in = s.d_inner(d)
        H = s.num_heads(d)
        out["ssd"] = d * (2 * d_in + 2 * s.d_state + H) + d_in * d
    if cfg.rglru:
        w = cfg.rglru.lru_width or d
        out["rglru"] = 2 * d * w + 2 * w * w + w * d
    out["unembed"] = d * cfg.vocab_size
    return out


@dataclasses.dataclass
class StepCosts:
    flops_fwd: float         # one forward pass, global
    flops_total: float       # phase total (bwd/remat multipliers applied)
    model_flops: float       # 6*N_active*D convention (2*N*D for inference)
    hbm_bytes: float         # global HBM traffic for the step
    tokens: float
    notes: str = ""


def step_costs(cfg: ModelConfig, shape: ShapeCfg, *, remat: str = "full",
               multi_pod: bool = False) -> StepCosts:
    phase = shape.phase
    B, S = shape.global_batch, shape.seq_len
    tokens = B * (1 if phase == "decode" else S)
    counts = _layer_counts(cfg)
    gp = _gemm_params(cfg)
    hq, hv = _attn_dims(cfg)
    nh = cfg.num_heads

    # ---- forward FLOPs ---------------------------------------------------
    gemm_p = (counts["attn"] * gp.get("attn", 0)
              + counts["cross"] * gp.get("cross", 0)
              + counts["dense_ff"] * gp.get("dense_ff", 0)
              + counts["moe_ff"] * gp.get("moe_ff_active", 0)
              + counts["ssd"] * gp.get("ssd", 0)
              + counts["rglru"] * gp.get("rglru", 0)
              + gp["unembed"])
    f_gemm = 2.0 * gemm_p * tokens

    win = cfg.rglru.window if cfg.rglru else 0
    if phase == "decode":
        kv_attn = min(S, win) if win else S        # context length per step
    else:
        kv_attn = min(S, win) if win else S / 2.0  # causal half

    f_attn = 2.0 * tokens * kv_attn * nh * (hq + hv) * counts["attn"]
    mem_len = 0
    if counts["cross"]:
        mem_len = (cfg.num_patches if cfg.family == "vlm"
                   else int(S * cfg.src_len_ratio))
        f_attn += 2.0 * tokens * mem_len * nh * 2 * cfg.head_dim_() \
            * counts["cross"]
    if counts["ssd"]:
        s = cfg.ssm
        H = s.num_heads(cfg.d_model)
        q = min(s.chunk, S)
        f_attn += 2.0 * tokens * (q * (s.d_state + s.head_dim)
                                  + s.d_state * s.head_dim) * H * counts["ssd"]
    if counts["rglru"]:
        w = cfg.rglru.lru_width or cfg.d_model
        f_attn += 10.0 * tokens * w * counts["rglru"]   # gates + scan

    flops_fwd = f_gemm + f_attn

    # ---- phase multipliers -------------------------------------------------
    if phase == "train":
        # full: +1 fwd everywhere; dots: GEMM outputs saved (batch-dim-free
        # dots only, so attention scores still recomputed per block)
        mult_gemm = 3.0 + (1.0 if remat == "full" else 0.0)
        mult_attn = (4.0 if remat == "dots" else mult_gemm) + 1.0
        flops_total = f_gemm * mult_gemm + f_attn * mult_attn
        if cfg.mtp:
            # extra block + unembed per MTP depth
            per_tok = 2.0 * (gp.get("attn", 0) + gp["dense_ff"]
                             + 2 * cfg.d_model ** 2 + gp["unembed"])
            flops_total += cfg.mtp.num_modules * per_tok * tokens * mult_gemm
    else:
        flops_total = flops_fwd

    # ---- MODEL_FLOPS convention -------------------------------------------
    from repro_torch.models.api import count_params
    n_active = count_params(cfg, active_only=True) \
        - cfg.vocab_size * cfg.d_model     # exclude emb table lookup
    model_flops = (6.0 if phase == "train" else 2.0) * n_active * tokens

    # ---- HBM bytes ----------------------------------------------------------
    P_total = count_params(cfg)
    P_active = count_params(cfg, active_only=True)
    d = cfg.d_model
    L = cfg.num_layers
    act_unit = tokens * d * 2.0
    if phase == "train":
        w_stream = P_active * BYTES_PARAM * (3 if remat == "full" else 2)
        opt = P_total * (2 + 8 + 8)        # grads + master rw + m/v rw
        acts = act_unit * L * 2 + act_unit * L * 6   # stack w+r, working set
        logits = tokens * cfg.vocab_size * 4 * 2
        hbm = w_stream + opt + acts + logits
    elif phase == "prefill":
        hbm = P_active * BYTES_PARAM + act_unit * L * 4 \
            + cache_bytes(cfg, B, S) + tokens * cfg.vocab_size * 2
    else:
        # decode weight traffic: dense weights once + the expert weights
        # actually touched this step (coverage = 1-(1-1/E)^(B*k); at B=128
        # k=8 nearly every expert is hit -> ~P_total, the MoE decode
        # memory wall; MTP's batch amplification (paper §2.3.3) is exactly
        # what amortizes this)
        if cfg.moe:
            E, kk = cfg.moe.num_experts, cfg.moe.top_k
            cov = 1.0 - (1.0 - 1.0 / E) ** (B * kk)
            expert_p = P_total - P_active
            from repro_torch.device import torch_dtype
            eb = (torch_dtype(cfg.expert_dtype).itemsize if cfg.expert_dtype
                  else BYTES_PARAM)
            w_read = P_active * BYTES_PARAM + expert_p * cov * eb
        else:
            w_read = P_active * BYTES_PARAM
        hbm = w_read + 2 * cache_bytes(cfg, B, S) \
            + act_unit * L * 4 + tokens * cfg.vocab_size * 2
    return StepCosts(flops_fwd, flops_total, model_flops, hbm, tokens)


def cache_bytes(cfg: ModelConfig, batch: int, context: int) -> float:
    """Decode-state bytes (the Table 1 quantity x batch x context)."""
    from repro_torch.device import torch_dtype
    cb = torch_dtype(cfg.cache_dtype_()).itemsize
    L = cfg.num_layers
    if cfg.attention == "mla":
        per_tok = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) * cb * L
        return batch * context * per_tok
    if cfg.family == "ssm":
        s = cfg.ssm
        H = s.num_heads(cfg.d_model)
        state = H * s.head_dim * s.d_state * 4
        conv = (s.d_conv - 1) * (s.d_inner(cfg.d_model) + 2 * s.d_state) * 2
        return batch * L * (state + conv)
    if cfg.family == "hybrid":
        plen = len(cfg.rglru.pattern)
        n_attn = cfg.num_layers // plen
        w = cfg.rglru.lru_width or cfg.d_model
        rec = (cfg.num_layers - n_attn) * (w * 4 + 3 * w * 2)
        att = n_attn * 2 * cfg.num_kv_heads * cfg.head_dim_() * 2 \
            * min(context, cfg.rglru.window)
        return batch * (rec + att)
    per_tok = 2 * cfg.num_kv_heads * cfg.head_dim_() * cb * L
    mem = 0.0
    if cfg.family == "vlm":
        mem = batch * cfg.num_patches * cfg.d_model * 2
    if cfg.family == "encdec":
        mem = batch * context * cfg.src_len_ratio * cfg.d_model * 2
    return batch * context * per_tok + mem
