"""DeepSeek-V3 671B — the paper's own architecture. [arXiv:2412.19437; hf]

61 layers (first 3 dense FF d_ff=18432), d_model=7168, 128 heads, MLA
(kv_lora 512, q_lora 1536, nope 128, rope 64, v 128), MoE: 256 routed
experts top-8 + 1 shared, expert_ff=2048, node-limited routing with 8
groups / limit 4, sigmoid scores with aux-loss-free bias, MTP depth 1.
"""
from repro_torch.configs.base import (MLAConfig, MoEConfig, ModelConfig,
                                      MTPConfig, register)

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,          # MLA: per-head K/V reconstructed from latent
    d_ff=18432,                # dense layers' FF
    vocab_size=129280,
    head_dim=128,              # v_head_dim; qk dims come from MLAConfig
    attention="mla",
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, expert_ff=2048, num_shared=1,
                  num_groups=8, group_limit=4, group_top=2,
                  router_bias=True, score_fn="sigmoid", route_norm=True,
                  route_scale=2.5, layout="dense_first:3"),
    mtp=MTPConfig(num_modules=1, loss_weight=0.3),
    fp8=True,
    source="arXiv:2412.19437 (DeepSeek-V3 technical report); paper §2",
))
