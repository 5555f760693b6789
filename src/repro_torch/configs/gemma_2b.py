"""gemma-2b: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000, GeGLU,
head_dim=256 [arXiv:2403.08295]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, activation="geglu", tie_embeddings=True,
))
