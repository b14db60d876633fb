"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256; cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-90B-Vision; unverified]

The vision frontend is a stub, as in the reference: a request carries
precomputed patch embeddings ``patch_embeds`` (batch, num_patches,
d_model), read by the cross-attention layers; only the language backbone
is modeled.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,            # includes the 20 cross-attn layers (every 5th)
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    attention="gqa",
    rope_theta=500000.0,
    cross_attn_every=5,
    num_patches=1601,
    source="hf:meta-llama/Llama-3.2-90B-Vision (assignment dims)",
))
