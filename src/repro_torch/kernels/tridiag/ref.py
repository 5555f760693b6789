"""Oracles for batched tridiagonal solvers, as ``repro.kernels.tridiag.ref``
defines them.

System i of a batch: a[i,0] = 0 and c[i,n-1] = 0 (standard convention);
    a[i,j]*x[i,j-1] + b[i,j]*x[i,j] + c[i,j]*x[i,j+1] = d[i,j]
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def thomas_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               d: torch.Tensor) -> torch.Tensor:
    """The sequential Thomas algorithm — the exact ground truth (one step
    per equation: for a sample of rows, not for the full batch at large n)."""
    n = a.shape[-1]
    cp_prev = torch.zeros_like(a[..., 0])
    dp_prev = torch.zeros_like(a[..., 0])
    cps, dps = [], []
    for i in range(n):
        ai, bi, ci, di = a[..., i], b[..., i], c[..., i], d[..., i]
        denom = bi - ai * cp_prev
        cp_prev = ci / denom
        dp_prev = (di - ai * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    x = torch.empty_like(a)
    x_next = torch.zeros_like(a[..., 0])
    for i in reversed(range(n)):
        x_next = dps[i] - cps[i] * x_next
        x[..., i] = x_next
    return x


def dense_solve_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """Builds the dense matrix per system and solves — small-n oracle."""
    n = a.shape[-1]
    idx = torch.arange(n, device=a.device)
    mat = torch.zeros(a.shape[:-1] + (n, n), dtype=a.dtype, device=a.device)
    mat[..., idx, idx] = b
    mat[..., idx[1:], idx[:-1]] = a[..., 1:]
    mat[..., idx[:-1], idx[1:]] = c[..., :-1]
    return torch.linalg.solve(mat, d.unsqueeze(-1))[..., 0]


def random_system(generator: torch.Generator, batch: int, n: int,
                  dtype: torch.dtype = torch.float32,
                  device: Optional[torch.device] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """Diagonally dominant random system (well conditioned for every
    solver): the JAX package's distribution — a, c ~ U[0.1, 1) with
    a[:, 0] = c[:, -1] = 0, b = |a| + |c| + U[1, 2), d ~ N(0, 1) — drawn
    from a ``torch.Generator`` (other draws than ``jax.random``'s)."""
    device = device if device is not None else generator.device

    def uniform(lo, hi):
        u = torch.rand(batch, n, generator=generator, device=device,
                       dtype=dtype)
        return u * (hi - lo) + lo

    a = uniform(0.1, 1.0)
    c = uniform(0.1, 1.0)
    a[:, 0] = 0.0
    c[:, -1] = 0.0
    b = a.abs() + c.abs() + uniform(1.0, 2.0)
    d = torch.randn(batch, n, generator=generator, device=device, dtype=dtype)
    return a, b, c, d


def residual(a, b, c, d, x) -> torch.Tensor:
    """max |A x - d| — solver-independent correctness check."""
    ax = (a * F.pad(x, (1, 0))[:, :-1]
          + b * x
          + c * F.pad(x, (0, 1))[:, 1:])
    return (ax - d).abs().max()
