"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone.

24L per stack, d_model=1024, 16H (GQA kv=16 => MHA), d_ff=8192,
vocab=256206.  [arXiv:2308.11596; hf]

The audio frontend is a stub, as in the reference: a request carries
precomputed frame embeddings ``src_embeds`` of shape (batch, src_len,
d_model); only the transformer encoder-decoder backbone is modeled.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,             # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    attention="gqa",
    act="gelu",
    src_len_ratio=0.25,
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large",
))
