"""llama-3.2-vision-90b: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — cross-attn image layers every 5th; vision frontend STUB
[hf:meta-llama/Llama-3.2-90B-Vision]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256, activation="swiglu",
    activation_strategy="sp",
    cross_attn_every=5, vision_len=1601, rope_theta=500000.0,
))
