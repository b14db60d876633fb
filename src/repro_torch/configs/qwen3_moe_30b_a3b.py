"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) expert_ff=768
vocab=151936, MoE 128 experts top-8 (no shared expert), qk_norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,                  # = expert_ff; all layers MoE
    vocab_size=151936,
    head_dim=128,
    attention="gqa",
    qk_norm=True,
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, top_k=8, expert_ff=768, num_shared=0,
                  num_groups=8, group_limit=4, score_fn="softmax",
                  route_norm=True, router_bias=False, layout="all"),
    source="hf:Qwen/Qwen3-30B-A3B",
))
