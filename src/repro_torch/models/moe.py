"""Mixture-of-Experts block: grouped GShard top-k dispatch.

The PyTorch port of ``repro.models.moe``.  Routing is computed per group of
``moe_group_size`` tokens (GShard's S): the dispatch and combine tensors
are (G, S, E, C), with a capacity C of about S k / E slots an expert, so
the whole object is linear in the tokens.  ``MoE`` holds the parameters
under the JAX tree's names (``router``, ``wi`` / ``wu`` of (E, d, f),
``wo`` of (E, f, d), the optional ``shared`` MLP).  The einsums are plain
products, outside any kernel in the JAX package too.  In a distributed
step (DTensors) ``_expert_constraint`` shards the expert dim on "model"
(EP) as the JAX package does; on plain tensors it is the identity.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

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
