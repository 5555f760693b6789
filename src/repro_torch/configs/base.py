"""Model configuration schema and registry of the port.

The PyTorch port's own copy of ``repro.configs.base`` (``ModelConfig``,
``register``, ``reduced()``, ``get_arch``, and the dry-run's cells
``ShapeConfig`` / ``SHAPES`` / ``shape_applicable``), field for field, so
a configuration and its reduced smoke-test variant are the same in both
packages.  The registry holds the JAX package's ten configurations;
``HybridMoEConfig`` and the configurations registered with ``port_only``
are the port's own, which ``get_arch`` finds and ``all_archs`` leaves out.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    arch: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    # transformer backbone
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 0
    activation: str = "swiglu"        # swiglu | geglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # attention
    attn_window: Optional[int] = None     # local sliding window (recurrentgemma)
    sub_quadratic: bool = False           # supports 500k-token decode
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024            # GShard routing group S
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # hybrid (recurrentgemma): layer pattern period, e.g. ("rec","rec","attn")
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    enc_len: int = 1500                   # precomputed frame embeddings (stub)
    # vlm
    cross_attn_every: int = 0             # insert cross-attn each k-th layer
    vision_len: int = 1601                # precomputed patch embeddings (stub)
    # numerics / execution
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"                   # none | full
    use_pallas: bool = False              # flip on for real deployments: the
    #                                       tuned flash kernel in prefill
    activation_strategy: str = "sp"       # sp | tp (residual-stream sharding;
    #                                       sp shrinks per-layer remat saves
    #                                       by the model-axis size)
    logits_softcap: float = 0.0
    # distribution hints (set by the launcher; 0/() = no explicit
    # constraints, e.g. host smoke tests without a mesh context)
    model_axis_size: int = 0
    batch_axes: Tuple[str, ...] = ()
    batch_shards: int = 0                 # product of batch-axis sizes
    pure_dp: bool = False                 # replicate params; batch over the
    #                                       whole mesh (small-model mapping:
    #                                       TP all-reduces vanish)

    @property
    def is_enc_dec(self) -> bool:
        return self.family == "audio"

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/topology, tiny dimensions."""
        period = max(len(self.block_pattern), 1)
        n_layers = max(2 * period, 2) if self.n_layers else 0
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, n_layers) or self.n_layers,
            d_model=min(self.d_model, 64) if self.d_model else 0,
            n_heads=min(self.n_heads, 4) or self.n_heads,
            n_kv_heads=max(min(self.n_kv_heads, 2), 1) if self.n_kv_heads else 0,
            head_dim=min(self.head_dim, 16) or self.head_dim,
            d_ff=min(self.d_ff, 128) if self.d_ff else 0,
            d_ff_expert=min(self.d_ff_expert, 64) if self.d_ff_expert else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            capacity_factor=4.0,   # avoid token drops in tiny smoke batches
            #                        (capacity effects are exercised at scale)
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 8),
            lru_width=min(self.lru_width, 64) if self.lru_width else 0,
            n_enc_layers=min(self.n_enc_layers, 2) if self.n_enc_layers else 0,
            n_dec_layers=min(self.n_dec_layers, 2) if self.n_dec_layers else 0,
            enc_len=min(self.enc_len, 16),
            vision_len=min(self.vision_len, 16),
            cross_attn_every=min(self.cross_attn_every, 2) if self.cross_attn_every else 0,
            attn_window=min(self.attn_window, 32) if self.attn_window else None,
            param_dtype="float32",
            compute_dtype="float32",
            remat="none",
        )


@dataclasses.dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """Family "hybrid_moe" (GraniteMoeHybrid): each layer runs one mixer,
    a Mamba-2 block ("mamba": the published mixer, with its conv bias,
    x scaled by dt and the D skip) or causal GQA attention without a
    positional encoding ("attention"), as ``block_pattern`` lists them for
    one period, then a dropless MoE of ``n_experts`` SwiGLU experts of
    ``d_ff_expert`` beside a shared SwiGLU expert of ``d_ff_shared``.  The
    embedding is scaled by ``embedding_multiplier``, each branch by
    ``residual_multiplier`` before its residual add, attention scores by
    ``attention_multiplier`` and the logits by 1 / ``logits_scaling``."""
    d_ff_shared: int = 0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 1.0
    logits_scaling: float = 1.0

    def reduced(self) -> "HybridMoEConfig":
        """One period of the layer pattern at the tiny widths of
        ``ModelConfig.reduced``."""
        return dataclasses.replace(
            super().reduced(), n_layers=len(self.block_pattern),
            d_ff_shared=min(self.d_ff_shared, 128))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: Dict[str, ModelConfig] = {}
_PORT_ONLY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, port_only: bool = False) -> ModelConfig:
    """Register ``cfg`` under its arch; ``port_only`` for a configuration
    the JAX package does not have (left out of ``all_archs``)."""
    (_PORT_ONLY if port_only else _REGISTRY)[cfg.arch] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    # a config module imported on its own registers only itself
    if name not in _REGISTRY and name not in _PORT_ONLY:
        _load_all()
    return _REGISTRY[name] if name in _REGISTRY else _PORT_ONLY[name]


def all_archs() -> Tuple[str, ...]:
    _load_all()
    return tuple(sorted(_REGISTRY))


def _load_all() -> None:
    # importing the config modules populates the registry
    import importlib
    for mod in ("gemma_2b", "minitron_4b", "qwen15_05b", "granite_34b",
                "whisper_large_v3", "llama32_vision_90b", "qwen2_moe_a27b",
                "qwen3_moe_30b_a3b", "recurrentgemma_9b", "mamba2_130m",
                "granite_4h_small"):
        importlib.import_module(f"repro_torch.configs.{mod}")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k-token decode requires "
                       "sub-quadratic attention (skip per assignment)")
    return True, ""
