"""granite-4.0-h-small (GraniteMoeHybrid) as the configuration file states
it, in plain float32 PyTorch with TF32 off, one prompt at a time; its
weights, drawn from the seed one tensor at a time; and its control.

The forward (the configuration's ``departures`` name where it follows the
port's parametrisation): the embedding times ``embedding_multiplier``;
per layer of ``layer_types`` a residual x + m * mixer(rms_norm(x) (1 +
ln1)) and then x + m * (moe(u) + shared(u)) with u = rms_norm(x) (1 +
ln2) and m the ``residual_multiplier``; the final norm, the tied
unembedding, and the logits over ``logits_scaling``.

  * "mamba": in_proj splits into x, z, b, c and dt_raw; a depthwise causal
    conv with its bias and silu act on [x, b, c]; dt = softplus(dt_raw +
    dt_bias), a = exp(-exp(a_log) dt); y is the state-space recurrence
    h_t = a_t h_{t-1} + b_t (dt_t x_t)^T, y_t = h_t^T c_t per head (the
    chunked form of ``reference.mamba2.ssd``), plus the skip D x per head;
    then out_proj(rms_norm(y * silu(z)) (1 + norm)) over all d_inner
    channels (one group).
  * "attention": causal GQA without a positional encoding, query head j on
    key and value head j // (heads / kv heads), scores times
    ``attention_multiplier``.
  * the MoE: the router's logits in float32, the top
    ``num_experts_per_tok`` of them and a softmax over those; every
    (token, choice) computed, no capacity: silu(u wi) * (u wu) wo of its
    expert times its weight, summed over the choices; the shared SwiGLU
    expert of ``shared_intermediate_size`` added.

The control puts the model one precision step below the configuration's,
as ``reference.mamba2`` does: every value the configuration computes in
bf16 on float8 e4m3 with one scale a tensor, every value it computes in
float32 (the router's logits and weights, dt, the decays, the SSD and its
skip, the attention's scores, the logits) on bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.mamba2 import _bf16, _fp8, _rms, _silu, exact_f32, ssd

ATTN_BLOCK = 1024          # query rows a block of the attention's scores


def dims(cfg: Dict) -> Dict[str, int]:
    d = cfg["hidden_size"]
    s = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    d_inner = cfg["mamba_expand"] * d
    heads = cfg["mamba_n_heads"]
    return {"d": d, "d_inner": d_inner, "heads": heads,
            "head_dim": cfg["mamba_d_head"], "state": s,
            "chan": d_inner + 2 * s, "in_proj": 2 * d_inner + 2 * s + heads,
            "q_heads": cfg["num_attention_heads"],
            "kv_heads": cfg["num_key_value_heads"],
            "attn_head_dim": d // cfg["num_attention_heads"],
            "experts": cfg["num_local_experts"],
            "top_k": cfg["num_experts_per_tok"],
            "expert": cfg["intermediate_size"],
            "shared": cfg["shared_intermediate_size"],
            "vocab": cfg["vocab_size"], "conv": cfg["mamba_d_conv"]}


def layer_kinds(cfg: Dict):
    """The mixer of each layer held: the first ``num_hidden_layers`` of
    ``layer_types``."""
    return cfg["layer_types"][:cfg["num_hidden_layers"]]


def _layer_specs(cfg: Dict, kind: str):
    """(name, shape, how it is drawn) of one layer's tensors, in order."""
    n = dims(cfg)
    d, e, f, fs = n["d"], n["experts"], n["expert"], n["shared"]
    if kind == "mamba":
        mixer = [("in_proj", (d, n["in_proj"]), ("normal", d)),
                 ("conv", (n["conv"], n["chan"]), ("normal", n["conv"])),
                 ("conv_bias", (n["chan"],), ("uniform", n["conv"])),
                 ("a_log", (n["heads"],), ("a_log",)),
                 ("dt_bias", (n["heads"],), ("dt_bias",)),
                 ("d_skip", (n["heads"],), ("d_skip",)),
                 ("norm", (n["d_inner"],), ("scale",)),
                 ("out_proj", (n["d_inner"], d), ("normal", n["d_inner"]))]
    else:
        hd = n["attn_head_dim"]
        mixer = [("wq", (d, n["q_heads"] * hd), ("normal", d)),
                 ("wk", (d, n["kv_heads"] * hd), ("normal", d)),
                 ("wv", (d, n["kv_heads"] * hd), ("normal", d)),
                 ("attn_out", (n["q_heads"] * hd, d),
                  ("normal", n["q_heads"] * hd))]
    return ([("ln1", (d,), ("scale",))] + mixer
            + [("ln2", (d,), ("scale",)),
               ("router", (d, e), ("normal", d)),
               ("wi", (e, d, f), ("normal", d)),
               ("wu", (e, d, f), ("normal", d)),
               ("wo", (e, f, d), ("normal", f)),
               ("shared_wi", (d, fs), ("normal", d)),
               ("shared_wu", (d, fs), ("normal", d)),
               ("shared_wo", (fs, d), ("normal", fs))])


def _draw_one(shape, how, gen: torch.Generator, dtype: torch.dtype
              ) -> torch.Tensor:
    dev = gen.device
    if how[0] == "normal":
        t = torch.randn(shape, generator=gen, device=dev) / math.sqrt(how[1])
        return t.to(dtype)
    if how[0] == "uniform":
        bound = 1.0 / math.sqrt(how[1])
        t = (2.0 * torch.rand(shape, generator=gen, device=dev) - 1.0) * bound
        return t.to(dtype)
    if how[0] == "scale":
        return (0.1 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    u = torch.rand(shape, generator=gen, device=dev)
    if how[0] == "a_log":
        return torch.log(1.0 + 15.0 * u)
    if how[0] == "dt_bias":
        dt = torch.exp(math.log(1e-3) + (math.log(1e-1) - math.log(1e-3)) * u)
        return dt + torch.log(-torch.expm1(-dt))
    return 0.5 + u                                            # d_skip


def draw(cfg: Dict, gen: torch.Generator
         ) -> Iterator[Tuple[Optional[int], str, torch.Tensor]]:
    """The weights as (layer or None, name, tensor), one tensor at a time
    on ``gen``'s device, in the types they are served in (bf16; a_log,
    dt_bias and d_skip float32): projections, experts and the embedding
    N(0, 1) / sqrt(fan-in), the conv N(0, 1) / sqrt(width) and its bias
    U(-1, 1) / sqrt(width) (a depthwise conv's default), norm scales 0.1
    N(0, 1), a_log = log U[1, 16), dt_bias the inverse softplus of dt
    log-uniform in [0.001, 0.1), D in U[0.5, 1.5)."""
    bf = getattr(torch, cfg["param_dtype"])
    n = dims(cfg)
    yield None, "embed", _draw_one((n["vocab"], n["d"]), ("normal", n["d"]),
                                   gen, bf)
    for i, kind in enumerate(layer_kinds(cfg)):
        for name, shape, how in _layer_specs(cfg, kind):
            yield i, name, _draw_one(shape, how, gen, bf)
    yield None, "final_norm", _draw_one((n["d"],), ("scale",), gen, bf)


def collect(drawn) -> Dict:
    """``draw``'s tensors as the weights ``forward`` reads: ``embed``,
    ``final_norm`` and ``layers``, one dict of tensors a layer."""
    w: Dict = {"layers": []}
    for i, name, value in drawn:
        if i is None:
            w[name] = value
        else:
            while len(w["layers"]) <= i:
                w["layers"].append({})
            w["layers"][i][name] = value
    return w


def _mamba(lw: Dict, u: torch.Tensor, cfg: Dict, lo, hi):
    """(the mixer's output, its gated norm input's root mean square a
    position)."""
    n = dims(cfg)
    L, k = u.shape[0], n["conv"]
    z_all = lo(u @ lo(lw["in_proj"].float()))
    xs, z, bc, dt_raw = torch.split(
        z_all, [n["d_inner"], n["d_inner"], 2 * n["state"], n["heads"]],
        dim=-1)
    conv_in = torch.cat([xs, bc], dim=-1)
    cw = lo(lw["conv"].float())
    padded = torch.cat([conv_in.new_zeros(k - 1, conv_in.shape[1]), conv_in])
    conv = lo(sum(padded[j:j + L] * cw[j] for j in range(k))
              + lo(lw["conv_bias"].float()))
    conv = lo(_silu(conv))
    xs, b, c = torch.split(conv, [n["d_inner"], n["state"], n["state"]],
                           dim=-1)
    dt = hi(F.softplus(dt_raw + hi(lw["dt_bias"])))
    a = hi(torch.exp(-torch.exp(hi(lw["a_log"])) * dt))
    xh = xs.reshape(L, n["heads"], n["head_dim"])
    y = hi(ssd(hi(xh * dt[..., None]), a, b, c)) \
        + hi(hi(lw["d_skip"])[:, None] * xh)
    g = lo(lo(y).reshape(L, n["d_inner"]) * lo(_silu(z)))
    g_rms = g.square().mean(-1).sqrt()
    y = lo(_rms(g, lw["norm"], cfg["rms_norm_eps"]))
    return lo(y @ lo(lw["out_proj"].float())), g_rms


def _attention(lw: Dict, u: torch.Tensor, cfg: Dict, lo, hi
               ) -> torch.Tensor:
    n = dims(cfg)
    L, hq, hkv, hd = u.shape[0], n["q_heads"], n["kv_heads"], \
        n["attn_head_dim"]
    q = lo(u @ lo(lw["wq"].float())).view(L, hq, hd)
    k = lo(u @ lo(lw["wk"].float())).view(L, hkv, hd)
    v = lo(u @ lo(lw["wv"].float())).view(L, hkv, hd)
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    pos = torch.arange(L, device=u.device)
    out = torch.empty(L, hq, hd, device=u.device)
    for s in range(0, L, ATTN_BLOCK):
        e = min(s + ATTN_BLOCK, L)
        scores = hi(hi(torch.einsum("qhd,khd->hqk", q[s:e], k[:e]))
                    * cfg["attention_multiplier"])
        scores = scores.masked_fill(pos[None, s:e, None] < pos[None, None, :e],
                                    float("-inf"))
        p = lo(torch.softmax(scores, dim=-1))
        out[s:e] = lo(torch.einsum("hqk,khd->qhd", p, v[:e]))
    return lo(out.reshape(L, hq * hd) @ lo(lw["attn_out"].float()))


def moe(lw: Dict, u: torch.Tensor, cfg: Dict, lo=None, hi=None
        ) -> torch.Tensor:
    """One layer's MoE and shared expert over u (T, D), its post-norm input:
    ``lo`` and ``hi`` as in ``forward`` (the identity when not given)."""
    lo = lo or (lambda t: t)
    hi = hi or (lambda t: t)
    n = dims(cfg)
    logits = hi(u @ hi(lw["router"].float()))
    top, idx = torch.topk(logits, n["top_k"], dim=-1)
    gate = hi(torch.softmax(top, dim=-1))
    out = torch.zeros_like(u)
    for e in range(n["experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = u[tok]
        g = lo(x @ lo(lw["wi"][e].float()))
        up = lo(x @ lo(lw["wu"][e].float()))
        y = lo(lo(lo(_silu(g)) * up) @ lo(lw["wo"][e].float()))
        out.index_add_(0, tok, y * gate[tok, slot, None])
    g = lo(u @ lo(lw["shared_wi"].float()))
    up = lo(u @ lo(lw["shared_wu"].float()))
    shared = lo(lo(lo(_silu(g)) * up) @ lo(lw["shared_wo"].float()))
    return lo(lo(out) + shared)


def forward(w: Dict, tokens: torch.Tensor, cfg: Dict, control: bool = False):
    """(logits (L, V) in float32, conditioning (L,)) of one prompt
    ``tokens`` (L,).  A position's conditioning is the least, over the
    Mamba-2 layers, of its gated-norm input's root mean square over the
    median position's (``reference.mamba2.forward``).

    ``lo`` marks each value the configuration computes in its compute type
    (bf16) and ``hi`` each it computes in float32: both the identity here,
    float8 and bfloat16 in the control."""
    eps, m = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    lo = _fp8 if control else (lambda t: t)
    hi = _bf16 if control else (lambda t: t)
    with exact_f32():
        x = lo(w["embed"][tokens].float() * cfg["embedding_multiplier"])
        cond = torch.full((x.shape[0],), float("inf"), device=x.device)
        for lw, kind in zip(w["layers"], layer_kinds(cfg)):
            u = lo(_rms(x, lw["ln1"], eps))
            if kind == "mamba":
                h, g_rms = _mamba(lw, u, cfg, lo, hi)
                cond = torch.minimum(cond, g_rms / g_rms.median().clamp_min(
                    torch.finfo(torch.float32).tiny))
            else:
                h = _attention(lw, u, cfg, lo, hi)
            x = lo(x + lo(h * m))
            u = lo(_rms(x, lw["ln2"], eps))
            x = lo(x + lo(moe(lw, u, cfg, lo, hi) * m))
        x = lo(_rms(x, w["final_norm"], eps))
        logits = hi(hi(x) @ hi(w["embed"].float()).t())
        return logits.div_(cfg["logits_scaling"]), cond
