"""granite-4.0-h-small's forward from its widths: 2 operations a matrix
parameter a token that reaches it (each layer's mixer projections, the
router, the top-k experts a token computes and the shared expert, the tied
unembedding), plus the SSD's linear-time operations (``work.ssd``) in each
Mamba-2 layer and 4 head_dim operations a causal (query, key) pair and
head in each attention layer; and the least time of one MoE layer."""
from portbench.reference.granite4h import dims, layer_kinds
from portbench.work import ssd
from portbench.work.peaks import BF16_FLOPS, least_s


def mixer_params(cfg: dict, kind: str) -> int:
    n = dims(cfg)
    if kind == "mamba":
        return n["d"] * n["in_proj"] + n["d_inner"] * n["d"]
    attn = n["attn_head_dim"] * (2 * n["q_heads"] + 2 * n["kv_heads"])
    return n["d"] * attn


def moe_active_params(cfg: dict) -> int:
    """The router, the top-k experts and the shared expert: the matrix
    parameters one token reaches in an MoE layer."""
    n = dims(cfg)
    return n["d"] * (n["experts"] + 3 * n["top_k"] * n["expert"]
                     + 3 * n["shared"])


def params(cfg: dict) -> int:
    """Every parameter held (norm scales, conv, biases and the SSD's per
    head vectors included)."""
    n = dims(cfg)
    d = n["d"]
    moe = d * n["experts"] + 3 * d * (n["experts"] * n["expert"]
                                      + n["shared"])
    total = n["vocab"] * d + d
    for kind in layer_kinds(cfg):
        total += 2 * d + moe + mixer_params(cfg, kind)
        if kind == "mamba":
            total += (n["conv"] + 1) * n["chan"] + 3 * n["heads"] \
                + n["d_inner"]
    return total


def flops(cfg: dict, batch: int, length: int) -> float:
    """Operations of one forward over ``batch`` prompts of ``length``."""
    n = dims(cfg)
    kinds = layer_kinds(cfg)
    per_token = n["vocab"] * n["d"] + sum(
        mixer_params(cfg, kind) + moe_active_params(cfg) for kind in kinds)
    total = 2.0 * per_token * batch * length
    ssd_flops = ssd.work(batch, length, n["heads"], n["head_dim"],
                         n["state"])[1]
    pairs = length * (length + 1) / 2
    attn_flops = 4.0 * n["attn_head_dim"] * n["q_heads"] * batch * pairs
    return total + sum(ssd_flops if kind == "mamba" else attn_flops
                       for kind in kinds)


def moe_work(cfg: dict, tokens: int):
    """(bytes, flops) of one MoE layer over ``tokens``: its bf16 weights
    (every expert, the shared expert, the router) read once, the tokens
    read and the output written once in bf16; 2 operations a reached
    parameter a token."""
    n = dims(cfg)
    d = n["d"]
    weights = d * n["experts"] + 3 * d * (n["experts"] * n["expert"]
                                          + n["shared"])
    return 2 * weights + 2 * 2 * tokens * d, \
        2.0 * tokens * moe_active_params(cfg)


def moe_least(cfg: dict, tokens: int) -> float:
    return least_s(*moe_work(cfg, tokens), BF16_FLOPS)
