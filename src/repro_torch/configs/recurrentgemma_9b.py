"""recurrentgemma-9b: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention (window 2048), pattern
(rec, rec, attn) [arXiv:2402.19427]. Sub-quadratic: runs long_500k."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch="recurrentgemma-9b", family="hybrid",
    n_layers=36,  # 38 rounded to the (rec,rec,attn) period per block pattern;
    # the two extra layers of the published config do not fit the strict 1:2
    # pattern — recorded in DESIGN.md (scan-over-groups requires uniformity)
    d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000, activation="geglu",
    activation_strategy="sp",
    block_pattern=("rec", "rec", "attn"), attn_window=2048, lru_width=4096,
    sub_quadratic=True,
))
