"""Shared layers of the port's models, as ``repro.models.layers`` defines
them: the ones the Mamba-2 block needs (``dense``, ``rms_norm``,
``causal_conv1d``, ``silu``).  ``x @ w`` stays a plain ``torch.matmul``: it is a
product outside any Pallas kernel in the JAX package too."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the sigmoid as 1 / (1 + exp(-x)), one rounding
    per operation in the input type: ``jax.nn.silu`` as XLA expands its
    logistic.  In bf16 ``F.silu`` (one rounding) differs from it in the
    last bit on many inputs, which the Mamba-2 block's RMS norm amplifies
    where a position's rms is near 0."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """The variance reduction in f32, the rest in the input type."""
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale.to(x.dtype))


def dense(w: torch.Tensor, x: torch.Tensor,
          compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    return x @ w


class Dense(nn.Module):
    """A (d_in, d_out) projection without bias; its weight is ``w``, as in
    the JAX parameter tree."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out, dtype=dtype,
                                          device=device))

    def reset(self, generator: torch.Generator) -> None:
        """N(0, 1) / sqrt(d_in) weights, drawn in f32 from ``generator``:
        the JAX package's ``init_dense`` scale."""
        with torch.no_grad():
            self.w.copy_(torch.randn(self.w.shape, generator=generator,
                                     device=self.w.device)
                         * (1.0 / math.sqrt(self.w.shape[0])))

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return dense(self.w, x, compute_dtype)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  cache: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, L, D); w: (K, D).

    Returns (y, new_cache) with cache = the last K-1 inputs (for decode)."""
    K = w.shape[0]
    if cache is None:
        ctx = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    else:
        ctx = torch.cat([cache.to(x.dtype), x], dim=1)
    L = x.shape[1]
    y = sum(ctx[:, i:i + L, :] * w[i][None, None, :] for i in range(K))
    new_cache = ctx[:, ctx.shape[1] - (K - 1):, :]
    return y.to(x.dtype), new_cache
