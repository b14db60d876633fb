"""Config system: model dataclasses + the arch registry.

A copy of the reference package's schema (``src/repro/configs/base.py``),
kept field for field so that one config means the same thing in both
packages. Only the archs the port runs register here; ``get_config``
resolves them by name and ``smoke_config`` shrinks them for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention dims (paper T1; DeepSeek-V2/V3)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    """DeepSeekMoE-family config (paper T2/T3)."""

    num_experts: int = 256
    top_k: int = 8
    expert_ff: int = 2048
    num_shared: int = 1            # shared experts (always-on)
    shared_ff: int = 0             # 0 -> same as expert_ff
    num_groups: int = 8            # expert groups ("nodes" in the paper)
    group_limit: int = 4           # max distinct groups per token (node-limited)
    group_top: int = 2             # per-group score = sum of top-`group_top` experts
    capacity_factor: float = 1.25  # static-shape capacity
    router_bias: bool = True       # aux-loss-free bias balancing (DeepSeek-V3)
    score_fn: str = "sigmoid"      # sigmoid (V3) | softmax
    route_norm: bool = True        # renormalize selected weights to sum 1
    route_scale: float = 1.0
    # Which layers are MoE. "all", "interleave:<k>" (every k-th layer MoE),
    # or "dense_first:<n>" (first n layers dense, rest MoE — DeepSeek-V3).
    layout: str = "all"

    def shared_ff_dim(self) -> int:
        return self.shared_ff or self.expert_ff

    def experts_per_group(self) -> int:
        assert self.num_experts % self.num_groups == 0
        return self.num_experts // self.num_groups


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD config."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256  # SSD block size

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU + local-attention hybrid config."""

    lru_width: int = 0           # 0 -> d_model
    conv_width: int = 4
    window: int = 2048           # local attention window
    pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")


@dataclass(frozen=True)
class MTPConfig:
    """Multi-Token Prediction module (paper T6)."""

    num_modules: int = 1
    loss_weight: float = 0.3


# ---------------------------------------------------------------------------
# Main model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0              # 0 -> d_model // num_heads
    attention: str = "gqa"         # gqa | mla | none | local
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"              # silu | gelu

    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    mtp: Optional[MTPConfig] = None

    encoder_layers: int = 0
    src_len_ratio: float = 0.25
    cross_attn_every: int = 0
    num_patches: int = 1601

    # numerics
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "bfloat16"
    cache_dtype: str = ""          # decode-cache dtype ("" -> dtype)
    expert_dtype: str = ""         # inference: expert weight storage dtype
    fp8: bool = False              # FP8-path GEMMs (paper T4)
    fp8_impl: str = "ref"          # ref (inline torch) | pallas (dispatch via
                                   # repro_torch.kernels.registry: the CUDA
                                   # kernel on a card, its plain version on
                                   # the CPU)

    source: str = ""

    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def cache_dtype_(self) -> str:
        return self.cache_dtype or self.dtype

    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    assert cfg.name not in _REGISTRY, f"duplicate arch {cfg.name}"
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str, **overrides) -> ModelConfig:
    _load_all()
    cfg = _REGISTRY[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


# The reference's eleven archs: its seven decoder-only transformers, its
# two recurrent families, the enc-dec and the vision family.
_ARCH_MODULES = [
    "deepseek_v3_671b",
    "glm4_9b",
    "yi_34b",
    "qwen1_5_4b",
    "qwen3_14b",
    "qwen3_moe_30b_a3b",
    "llama4_maverick_400b_a17b",
    "mamba2_2_7b",
    "recurrentgemma_9b",
    "seamless_m4t_large_v2",
    "llama_3_2_vision_90b",
]

_loaded = False


def _load_all() -> None:
    global _loaded
    if _loaded:
        return
    import importlib

    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a registered config to CPU-smoke scale, same family/features
    (the reference's rule, so both packages shrink to the same model)."""
    kw: dict = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads > 1 else 1,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        dtype="float32",
        param_dtype="float32",
    )
    if cfg.mla:
        kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                              qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
        kw["head_dim"] = 0
    if cfg.moe:
        layout = cfg.moe.layout
        if layout.startswith("dense_first"):
            layout = "dense_first:1"
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=min(cfg.moe.top_k, 2), expert_ff=64,
            shared_ff=64 if cfg.moe.num_shared else 0,
            num_groups=4, group_limit=2, layout=layout)
    if cfg.ssm:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                              chunk=32)
    if cfg.rglru:
        kw["rglru"] = dataclasses.replace(cfg.rglru, lru_width=0, window=32)
        kw["num_layers"] = 3   # one full pattern block
        kw["num_kv_heads"] = 1
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    if cfg.cross_attn_every:
        kw["cross_attn_every"] = 2
        kw["num_patches"] = 16
        kw["num_layers"] = 4
    if cfg.mtp:
        kw["mtp"] = cfg.mtp
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
