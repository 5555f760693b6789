"""minitron-4b: 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000 —
pruned nemotron [arXiv:2407.14679]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab=256000, activation="swiglu",
    activation_strategy="sp",
))
