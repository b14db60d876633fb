"""mamba2-2.7b [ssm] — 64L d_model=2560, attention-free SSD (state-space
duality), ssm_state=128, vocab=50280.  [arXiv:2405.21060; unverified]

MLA is inapplicable (attention-free): the SSD recurrent state is the
per-layer decode state, whatever the context length.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=80,              # d_inner / head_dim = 5120/64
    num_kv_heads=0,
    d_ff=0,                    # no MLP; the mixer is the whole block
    vocab_size=50280,
    attention="none",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    source="arXiv:2405.21060; hf:state-spaces/mamba2-2.7b",
))
