"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1 => MQA)
d_ff=12288, RG-LRU + local attention in a 2:1 (recurrent:attention)
pattern, vocab=256000.  [arXiv:2402.19427; unverified]

Sub-quadratic: recurrent layers are O(N), attention layers use a
2048-token sliding window, so the decode state is bounded.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    attention="local",
    act="gelu",
    rope_theta=10000.0,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4, window=2048,
                      pattern=("recurrent", "recurrent", "attention")),
    source="arXiv:2402.19427; hf:google/recurrentgemma-9b",
))
