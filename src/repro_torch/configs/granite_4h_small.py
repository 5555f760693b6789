"""granite-4.0-h-small (ibm-granite/granite-4.0-h-small, config.json;
model_type granitemoehybrid): 40 layers of width 4096 in periods of ten,
five Mamba-2 mixers, one NoPE GQA attention mixer and four Mamba-2 mixers,
every layer then a dropless MoE of 72 SwiGLU experts of width 768, 10 a
token, beside a shared SwiGLU expert of width 1536.  The port's own
configuration (no JAX counterpart)."""
from repro_torch.configs.base import HybridMoEConfig, register

CONFIG = register(HybridMoEConfig(
    arch="granite-4.0-h-small", family="hybrid_moe",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    vocab=100352, activation="swiglu", norm_eps=1e-5, tie_embeddings=True,
    n_experts=72, moe_top_k=10, d_ff_expert=768, d_ff_shared=1536,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    block_pattern=("mamba",) * 5 + ("attention",) + ("mamba",) * 4,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    attention_multiplier=0.0078125, logits_scaling=16.0,
), port_only=True)
