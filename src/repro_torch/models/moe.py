"""Mixture-of-Experts blocks: grouped GShard top-k dispatch, and the
dropless dispatch of the "hybrid_moe" family (``DroplessMoE``).

The PyTorch port of ``repro.models.moe``.  Routing is computed per group of
``moe_group_size`` tokens (GShard's S): the dispatch and combine tensors
are (G, S, E, C), with a capacity C of about S k / E slots an expert, so
the whole object is linear in the tokens.  ``MoE`` holds the parameters
under the JAX tree's names (``router``, ``wi`` / ``wu`` of (E, d, f),
``wo`` of (E, f, d), the optional ``shared`` MLP).  The einsums are plain
products, outside any kernel in the JAX package too.  In a distributed
step (DTensors) ``_expert_constraint`` shards the expert dim on "model"
(EP) as the JAX package does; on plain tensors it is the identity.

``DroplessMoE`` drops nothing: the (token, choice) assignments are sorted
by expert, each expert's rows run through one grouped product a weight
(``grouped_mm``), and each token's k outputs are combined back by index.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch import telemetry
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.hints import (UNCONSTRAINED, constrain,
                                          gather_weight)
from repro_torch.models.layers import MLP, Dense, _act, mlp


def padded_experts(cfg: ModelConfig) -> int:
    """Physical expert count, padded to a model-axis multiple so the JAX
    package's expert sharding divides evenly (pads never receive tokens:
    the router only emits real indices)."""
    e, m = cfg.n_experts, cfg.model_axis_size
    if m and e % m:
        return ((e + m - 1) // m) * m
    return e


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff_expert
        e = padded_experts(cfg)
        self.router = Dense(d, cfg.n_experts, dtype, device)
        self.wi = nn.Parameter(torch.zeros(e, d, f, dtype=dtype,
                                           device=device))
        self.wu = nn.Parameter(torch.zeros(e, d, f, dtype=dtype,
                                           device=device))
        self.wo = nn.Parameter(torch.zeros(e, f, d, dtype=dtype,
                                           device=device))
        self.shared = MLP(d, f * cfg.n_shared_experts, dtype, device) \
            if cfg.n_shared_experts else None

    def reset(self, generator: torch.Generator) -> None:
        """The JAX ``init_moe`` scales: a normal router over sqrt(d),
        ``wi`` and ``wu`` normal over sqrt(d), ``wo`` over sqrt(f)."""
        d, f = self.wi.shape[1], self.wi.shape[2]
        with torch.no_grad():
            self.router.reset(generator)
            for w, scale in ((self.wi, d), (self.wu, d), (self.wo, f)):
                w.copy_(torch.randn(w.shape, generator=generator,
                                    device=w.device) / math.sqrt(scale))
            if self.shared is not None:
                self.shared.reset(generator)


def _expert_constraint(t: torch.Tensor, cfg: ModelConfig,
                       e_dim: int) -> torch.Tensor:
    """Shard the expert dim on "model" (EP) when divisible; group dim on the
    batch axes. UNCONSTRAINED elsewhere (see attention._score_constraint)."""
    if not cfg.batch_axes or not cfg.model_axis_size or (
            cfg.batch_shards and t.shape[0] % cfg.batch_shards):
        return t
    b = cfg.batch_axes if len(cfg.batch_axes) > 1 else cfg.batch_axes[0]
    e = t.shape[e_dim]
    axes = [UNCONSTRAINED] * t.dim()
    axes[0] = b
    if e % cfg.model_axis_size == 0:
        axes[e_dim] = "model"
    return constrain(t, tuple(axes))


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: indices outside [0, n) give a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def group_size(cfg: ModelConfig, length: int) -> int:
    """GShard's S: ``moe_group_size`` (at most the length), halved until
    it divides the length."""
    s = min(getattr(cfg, "moe_group_size", 1024) or 1024, length)
    while length % s:
        s //= 2
    return max(s, 1)


def capacity(cfg: ModelConfig, s: int) -> int:
    """Slots an expert takes in a group of ``s`` tokens."""
    return max(int(math.ceil(s * cfg.moe_top_k / cfg.n_experts
                             * cfg.capacity_factor)), 1)


def route(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """The router's decisions for x (B, L, D): the group size s, the
    renormalised top-k weights and expert indices (G, S, k), the softmax
    probabilities (G, S, E) in f32, and each (token, choice)'s position in
    its expert's queue, token-major (G, S, k)."""
    bsz, l, d = x.shape
    s = group_size(cfg, l)
    g = bsz * (l // s)
    ep = padded_experts(cfg)
    gate_logits = p.router(x.reshape(g, s, d), torch.float32)    # (G, S, E)
    probs = torch.softmax(gate_logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)  # (G, S, k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return s, gate_w, gate_idx, probs, queue_positions(gate_idx, ep)


def queue_positions(gate_idx: torch.Tensor, ep: int) -> torch.Tensor:
    """Each (token, choice)'s position in its expert's queue, counted over
    the group's (S k) choices token-major: (G, S, k)."""
    g, s = gate_idx.shape[:2]
    flat = _one_hot(gate_idx, ep, torch.int32).reshape(g, -1, ep)
    pos = torch.cumsum(flat, dim=1) - flat                       # (G, S*k, E)
    return torch.sum(pos * flat, dim=-1).reshape(g, s, -1)


def moe_block(p: MoE, x: torch.Tensor, cfg: ModelConfig,
              compute_dtype: torch.dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output in x's type, the Switch load-balance aux in f32).
    x: (B, L, D)."""
    bsz, l, d = x.shape
    e, cd = cfg.n_experts, compute_dtype
    s, gate_w, gate_idx, probs, pos = route(p, x, cfg)
    g = bsz * (l // s)
    xg = x.reshape(g, s, d)

    # load-balance aux (Switch): E * mean_e(f_e * P_e), averaged over groups
    me = torch.mean(probs, dim=1)                                # (G, E)
    ce = torch.mean(torch.sum(_one_hot(gate_idx, e, torch.float32), dim=2),
                    dim=1)
    aux = e * torch.mean(torch.sum(me * ce, dim=-1))

    cap = capacity(cfg, s)
    keep = pos < cap
    disp_e = (_one_hot(gate_idx, padded_experts(cfg), cd)
              * keep[..., None].to(cd))                          # (G, S, k, Ep)
    pos_c = _one_hot(pos, cap, cd)                               # (G, S, k, C)
    dispatch = torch.einsum("gske,gskc->gsec", disp_e, pos_c)    # (G, S, E, C)
    dispatch = _expert_constraint(dispatch, cfg, 2)
    combine_w = torch.einsum("gsk,gske,gskc->gsec", gate_w.to(cd), disp_e,
                             pos_c)

    expert_in = torch.einsum("gsd,gsec->gecd", xg.to(cd), dispatch)
    expert_in = _expert_constraint(expert_in, cfg, 1)
    gih = _act(cfg.activation, torch.einsum("gecd,edf->gecf", expert_in,
                                            gather_weight(p.wi).to(cd)))
    u = torch.einsum("gecd,edf->gecf", expert_in, gather_weight(p.wu).to(cd))
    expert_out = torch.einsum("gecf,efd->gecd", gih * u, gather_weight(p.wo).to(cd))
    expert_out = _expert_constraint(expert_out, cfg, 1)

    out = torch.einsum("gsec,gecd->gsd", combine_w, expert_out)
    out = out.reshape(bsz, l, d)
    if p.shared is not None:
        out = out + mlp(p.shared, x, cfg.activation, cd)
    return out.to(x.dtype), aux.to(torch.float32)


def expert_ends(sorted_experts: torch.Tensor, n: int) -> torch.Tensor:
    """The end of each expert's rows among the assignments sorted by
    expert: (n,) int32, the last equal to the number of assignments."""
    experts = torch.arange(n, device=sorted_experts.device,
                           dtype=sorted_experts.dtype)
    return torch.searchsorted(sorted_experts, experts, right=True).to(
        torch.int32)


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """Rows of x (R, a), sorted by expert, times their expert's w (E, a,
    b): (R, b), expert j taking rows ends[j - 1] to ends[j].  On the card
    one grouped GEMM (``torch._grouped_mm``, bf16); elsewhere a product an
    expert, rows past ``ends[-1]`` left zero."""
    if x.is_cuda:
        return torch._grouped_mm(x, w, offs=ends)
    out = x.new_zeros(x.shape[0], w.shape[2])
    start = 0
    for j, end in enumerate(ends.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[j]
        start = end
    return out


class DroplessMoE(MoE):
    """The "hybrid_moe" family's MoE, called as a module: the router's
    softmax renormalised over its top k (the softmax of the top k logits),
    every assignment computed, and the shared SwiGLU expert of
    ``d_ff_shared`` added.  Nothing in its forward waits on the device;
    the counters (``telemetry.count_moe``) stay there."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__(cfg, dtype, device)
        self.cfg = cfg
        self.shared = MLP(cfg.d_model, cfg.d_ff_shared, dtype, device) \
            if cfg.d_ff_shared else None

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
        """x (..., D) -> (..., D) in x's type."""
        cfg, cd = self.cfg, compute_dtype
        d, k, e = x.shape[-1], cfg.moe_top_k, self.wi.shape[0]
        with telemetry.span("repro.model.moe") as span:
            span.note(dispatch="dropless")
            xf = x.reshape(-1, d)
            t = xf.shape[0]
            with telemetry.span("repro.moe.route"):
                probs = torch.softmax(self.router(xf, torch.float32), dim=-1)
                gate_w, gate_idx = torch.topk(probs, k, dim=-1)      # (T, k)
                gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True),
                                              min=1e-9)
                sorted_e, order = torch.sort(gate_idx.reshape(-1),
                                             stable=True)
                ends = expert_ends(sorted_e, e)
                counts = torch.diff(ends, prepend=ends.new_zeros(1))
                telemetry.count_moe(counts, t * k, ends)
            with telemetry.span("repro.moe.experts"):
                xs = xf.to(cd)[order // k]
                h = _act(cfg.activation, grouped_mm(xs, self.wi.to(cd), ends)) \
                    * grouped_mm(xs, self.wu.to(cd), ends)
                ys = grouped_mm(h, self.wo.to(cd), ends)
                # back to (token, choice) order, then each token's k rows
                # weighted and summed
                y = torch.empty_like(ys).index_copy_(0, order, ys)
                out = torch.bmm(gate_w.to(cd)[:, None, :],
                                y.view(t, k, d))[:, 0]
            if self.shared is not None:
                out = out + mlp(self.shared, xf, cfg.activation, cd)
        return out.view(x.shape).to(x.dtype)
