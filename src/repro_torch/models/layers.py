"""Shared layers of the port's models, as ``repro.models.layers`` defines
them: ``dense`` / ``Dense`` (optional bias), ``rms_norm``, the gated
``mlp``, ``rope``, the embedding (``embed``, ``unembed``),
``causal_conv1d``, ``silu`` and ``gelu``.  Parameters are ``nn.Module``
attributes named as the JAX parameter tree names them (``w``, ``b``,
``table``), so ``models.convert`` loads a JAX tree into them.  ``x @ w``
stays a plain ``torch.matmul``: it is a product outside any Pallas kernel
in the JAX package too.  In a distributed step (DTensors) the projections
gather the weights' FSDP shards and the activations' sequence shards first
(``distributed.hints``); on plain tensors those are identities."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.distributed.hints import (gather_inner, gather_weight,
                                          projection_output,
                                          sharded_one_hot)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the sigmoid as 1 / (1 + exp(-x)), one rounding
    per operation in the input type: ``jax.nn.silu`` as XLA expands its
    logistic.  In bf16 ``F.silu`` (one rounding) differs from it in the
    last bit on many inputs, which the Mamba-2 block's RMS norm amplifies
    where a position's rms is near 0."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """x * (0.5 * (1 + tanh(c * (x + 0.044715 * x^3)))), c = sqrt(2 / pi),
    one rounding per operation in the input type and the constants
    rounded to it first: ``jax.nn.gelu(approximate=True)`` as XLA expands
    it.  ``F.gelu(approximate="tanh")`` rounds once and differs in the
    last bit on 42% of bf16 inputs of 3 N(0, 1)."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=torch.float32,
                     device=x.device).to(x.dtype)
    k = torch.tensor(0.044715, dtype=torch.float32,
                     device=x.device).to(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """The variance reduction in f32, the rest in the input type."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale.to(x.dtype))


def dense(w: torch.Tensor, x: torch.Tensor,
          compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    # a distributed step gathers the weight's FSDP shards and the
    # activations' sequence shards first (identities on plain tensors)
    w = gather_weight(w)
    x = gather_inner(x)
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    return projection_output(x @ w)


class Dense(nn.Module):
    """A (d_in, d_out) projection; its weight is ``w`` and its optional bias
    ``b``, as in the JAX parameter tree."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 device=None, bias: bool = False):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out, dtype=dtype,
                                          device=device))
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype,
                                          device=device)) if bias else None

    def reset(self, generator: torch.Generator) -> None:
        """N(0, 1) / sqrt(d_in) weights, drawn in f32 from ``generator``, and
        a zero bias: the JAX package's ``init_dense`` scales."""
        with torch.no_grad():
            self.w.copy_(torch.randn(self.w.shape, generator=generator,
                                     device=self.w.device)
                         * (1.0 / math.sqrt(self.w.shape[0])))
            if self.b is not None:
                self.b.zero_()

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        y = dense(self.w, x, compute_dtype)
        if self.b is not None:
            y = y + self.b.to(y.dtype)
        return y


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name in ("swiglu", "silu"):
        return silu(x)
    if name in ("geglu", "gelu"):
        return gelu(x)
    raise ValueError(name)


class MLP(nn.Module):
    """The gated MLP: ``wi`` (gate), ``wu`` (up), ``wo`` (down)."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.wi = Dense(d_model, d_ff, dtype, device)
        self.wu = Dense(d_model, d_ff, dtype, device)
        self.wo = Dense(d_ff, d_model, dtype, device)

    def reset(self, generator: torch.Generator) -> None:
        for proj in (self.wi, self.wu, self.wo):
            proj.reset(generator)


def mlp(p: MLP, x: torch.Tensor, activation: str,
        compute_dtype: torch.dtype) -> torch.Tensor:
    g = _act(activation, p.wi(x, compute_dtype))
    u = p.wu(x, compute_dtype)
    return p.wo(g * u, compute_dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding with f32 angles. x: (B, L, H, D); positions: (B, L)
    int."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs       # (B, L, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class Embedding(nn.Module):
    """The (vocab, d_model) token table ``table``, shared with the
    unembedding (tied, as in every configuration of the JAX package)."""

    def __init__(self, vocab: int, d_model: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.table = nn.Parameter(torch.zeros(vocab, d_model, dtype=dtype,
                                              device=device))

    def reset(self, generator: torch.Generator) -> None:
        """N(0, 1) / sqrt(d_model), drawn in f32: ``init_embedding``."""
        with torch.no_grad():
            self.table.copy_(torch.randn(self.table.shape,
                                         generator=generator,
                                         device=self.table.device)
                             * (1.0 / math.sqrt(self.table.shape[1])))


def embed(p: Embedding, tokens: torch.Tensor, compute_dtype: torch.dtype,
          one_hot: bool = False) -> torch.Tensor:
    if one_hot:
        # distributed path: the gather's backward is a scatter-add that the
        # partitioner replicates to a full (V, D) per device; a one-hot
        # einsum keeps both forward and backward partitioned (vocab stays
        # on "model").  Exact: one 1 a row, so each output is one table
        # element plus zeros.
        table = gather_weight(p.table)
        oh = sharded_one_hot(tokens, table.shape[0], table, 0)
        oh = oh.to(compute_dtype)
        return torch.einsum("blv,vd->bld", oh, table.to(compute_dtype))
    return gather_weight(p.table).to(compute_dtype)[tokens]


def unembed(p: Embedding, x: torch.Tensor,
            softcap: float = 0.0) -> torch.Tensor:
    """Logits in f32 against the tied table; tanh softcap when set."""
    table = gather_weight(p.table)
    logits = torch.einsum("bld,vd->blv",
                          gather_inner(x).to(torch.float32),
                          table.to(torch.float32))
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  cache: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, L, D); w: (K, D).

    Returns (y, new_cache) with cache = the last K-1 inputs (for decode)."""
    K = w.shape[0]
    if cache is None:
        # the K-1 left zeros by a concatenation, not a pad: torch 2.11's
        # DTensor fails to plan a pad here (one zero row repeated, since L
        # may be below K-1)
        zero = torch.zeros_like(x[:, :1])
        ctx = torch.cat([zero] * (K - 1) + [x], dim=1)
    else:
        ctx = torch.cat([cache.to(x.dtype), x], dim=1)
    L = x.shape[1]
    y = sum(ctx[:, i:i + L, :] * w[i][None, None, :] for i in range(K))
    new_cache = ctx[:, ctx.shape[1] - (K - 1):, :]
    return y.to(x.dtype), new_cache
