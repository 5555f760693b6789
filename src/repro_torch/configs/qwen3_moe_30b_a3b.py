"""qwen3-moe-30b-a3b: 48L d_model=2048 32H (GQA kv=4) d_ff=768(expert)
vocab=151936, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=0, d_ff_expert=768, vocab=151936, activation="swiglu",
    n_experts=128, n_shared_experts=0, moe_top_k=8,
))
