"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm.  [hf:Qwen/Qwen3-14B; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    attention="gqa",
    qk_norm=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-14B",
))
