"""whisper-large-v3: enc-dec 32L+32L d_model=1280 20H d_ff=5120 vocab=51866 —
conv frontend STUB (precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch="whisper-large-v3", family="audio",
    n_layers=32, n_enc_layers=32, n_dec_layers=32,
    d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866, activation="gelu", enc_len=1500,
    activation_strategy="sp",
    rope_theta=10000.0,
))
