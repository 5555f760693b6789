"""mamba2-130m: 24L d_model=768 attn-free, ssm_state=128 — SSD
[arXiv:2405.21060]. Sub-quadratic: runs long_500k."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280, activation="swiglu",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    sub_quadratic=True,
))
