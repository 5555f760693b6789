"""qwen2-moe-a2.7b: 24L d_model=2048 16H (kv=16) d_ff=1408(expert)
vocab=151936, 60 routed experts top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, d_ff_expert=1408, vocab=151936, activation="swiglu",
    n_experts=60, n_shared_experts=4, moe_top_k=4, qkv_bias=True,
))
