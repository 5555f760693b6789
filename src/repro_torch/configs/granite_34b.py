"""granite-34b: 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152 —
llama-arch code model [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab=49152, activation="swiglu",
    activation_strategy="sp",
))
