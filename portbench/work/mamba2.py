"""A Mamba-2 language model's forward from its widths: 2 operations a
matrix parameter a token (the input and output projections of every layer
and the tied unembedding, its vocabulary padded as the weights are), plus
the SSD's linear-time operations (``work.ssd``)."""
from portbench.reference.mamba2 import vocab_rows
from portbench.work import ssd


def dims(cfg: dict):
    """(d_inner, heads, head dim, state) of a configuration file."""
    d_inner = cfg["expand"] * cfg["d_model"]
    return d_inner, d_inner // cfg["headdim"], cfg["headdim"], cfg["d_state"]


def matrix_params(cfg: dict) -> int:
    d = cfg["d_model"]
    d_inner, heads, _, s = dims(cfg)
    in_proj = d * (2 * d_inner + 2 * cfg["ngroups"] * s + heads)
    out_proj = d_inner * d
    return cfg["n_layer"] * (in_proj + out_proj) + vocab_rows(cfg) * d


def flops(cfg: dict, batch: int, length: int) -> float:
    """Operations of one forward over ``batch`` prompts of ``length``."""
    _, heads, p, s = dims(cfg)
    ssd_flops = ssd.work(batch, length, heads, p, s)[1]
    return (2.0 * matrix_params(cfg) * batch * length
            + cfg["n_layer"] * ssd_flops)
