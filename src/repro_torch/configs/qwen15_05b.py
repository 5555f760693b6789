"""qwen1.5-0.5b: 24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936 —
QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=2816, vocab=151936, activation="swiglu", qkv_bias=True,
))
