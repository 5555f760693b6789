"""Analytic parameter counting for MODEL_FLOPS (no tensor allocation): the
port's copy of ``repro.launch.params``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def _attn_params(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.head_dim
    return (d * cfg.n_heads * hd          # wq
            + 2 * d * cfg.n_kv_heads * hd  # wk, wv
            + cfg.n_heads * hd * d)        # wo


def _mlp_params(d: int, f: int) -> int:
    return 3 * d * f                       # gate, up, down


def active_param_count(cfg: ModelConfig) -> int:
    """Matmul-active parameters per token (MoE: only routed-in experts)."""
    d = cfg.d_model
    per_layer = 0
    if cfg.family in ("dense", "audio", "vlm"):
        per_layer = _attn_params(cfg) + _mlp_params(d, cfg.d_ff)
        n_layers = cfg.n_layers
        if cfg.family == "audio":
            n_layers = (cfg.n_enc_layers or cfg.n_layers) + \
                (cfg.n_dec_layers or cfg.n_layers)
            # decoder cross-attention
            per_layer += _attn_params(cfg) * (cfg.n_dec_layers or
                                              cfg.n_layers) // max(n_layers, 1)
        total = per_layer * n_layers
        if cfg.family == "vlm" and cfg.cross_attn_every:
            total += _attn_params(cfg) * (cfg.n_layers // cfg.cross_attn_every)
        return total
    if cfg.family == "moe":
        per_layer = _attn_params(cfg)
        per_layer += cfg.moe_top_k * _mlp_params(d, cfg.d_ff_expert)
        per_layer += cfg.n_shared_experts * _mlp_params(d, cfg.d_ff_expert)
        per_layer += d * cfg.n_experts     # router
        return per_layer * cfg.n_layers
    if cfg.family == "ssm":
        d_inner = cfg.ssm_expand * d
        n_heads = d_inner // cfg.ssm_head_dim
        per_layer = d * (2 * d_inner + 2 * cfg.ssm_state + n_heads)  # in_proj
        per_layer += d_inner * d           # out_proj
        if cfg.d_ff:
            per_layer += _mlp_params(d, cfg.d_ff)
        return per_layer * cfg.n_layers
    if cfg.family == "hybrid":
        w = cfg.lru_width or d
        rec_layer = 2 * d * w + 2 * w * w + w * d + _mlp_params(d, cfg.d_ff)
        attn_layer = _attn_params(cfg) + _mlp_params(d, cfg.d_ff)
        period = cfg.block_pattern
        n_rec = sum(1 for k in period if k == "rec")
        n_att = len(period) - n_rec
        groups = cfg.n_layers // max(len(period), 1)
        return groups * (n_rec * rec_layer + n_att * attn_layer)
    raise ValueError(cfg.family)


def audio_split_params(cfg: ModelConfig):
    """(encoder_params, decoder_params) for enc-dec MODEL_FLOPS."""
    d = cfg.d_model
    enc_layer = _attn_params(cfg) + _mlp_params(d, cfg.d_ff)
    dec_layer = 2 * _attn_params(cfg) + _mlp_params(d, cfg.d_ff)  # + cross
    n_enc = cfg.n_enc_layers or cfg.n_layers
    n_dec = cfg.n_dec_layers or cfg.n_layers
    return enc_layer * n_enc, dec_layer * n_dec


def total_param_count(cfg: ModelConfig) -> int:
    """All parameters incl. embeddings and full expert banks."""
    d = cfg.d_model
    total = cfg.vocab * d                  # tied embedding
    if cfg.family == "moe":
        per_layer = _attn_params(cfg)
        per_layer += cfg.n_experts * _mlp_params(d, cfg.d_ff_expert)
        per_layer += cfg.n_shared_experts * _mlp_params(d, cfg.d_ff_expert)
        per_layer += d * cfg.n_experts
        return total + per_layer * cfg.n_layers
    return total + active_param_count(cfg)
