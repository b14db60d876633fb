"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, MoE 128 experts top-1 + 1 shared, dense/MoE interleaved 1:1
("interleave:2"), early-fusion multimodal (text path modeled; assignment
dims).  [hf:meta-llama/Llama-4-Maverick-17B-128E; unverified]"""
from repro_torch.configs.base import MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=16384,                # dense (non-MoE) layers' FF (2x expert_ff)
    vocab_size=202048,
    head_dim=128,
    attention="gqa",
    rope_theta=500000.0,
    moe=MoEConfig(num_experts=128, top_k=1, expert_ff=8192, num_shared=1,
                  shared_ff=8192, num_groups=8, group_limit=2, group_top=1,
                  score_fn="sigmoid", route_norm=False, router_bias=False,
                  layout="interleave:2"),
    source="hf:meta-llama/Llama-4-Maverick-17B-128E (assignment dims)",
))
