"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552, RoPE.  [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    attention="gqa",
    rope_theta=10000.0,
    qkv_bias=True,             # GLM-4 uses bias on QKV
    source="hf:THUDM/glm-4-9b",
))
