"""Oracles for the scan kernel family, as ``repro.kernels.scan.ref``
defines them.  Rows of (batch, n) tensors; two monoids:

  - "add": the inclusive prefix sum (``jnp.cumsum`` there);
  - "linrec": the first-order linear recurrence h_t = a_t h_{t-1} + b_t
    over pairs (a, b), monoid (a2, b2) o (a1, b1) = (a1 a2, a2 b1 + b2).

They check the kernels; ``scan_linrec_assoc_ref`` is also what
``driver.linrec_rows`` runs where the radix spaces have no config (the
JAX package's routing for odd lengths).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.blocks.associative import associative_scan


def scan_add_ref(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis."""
    return torch.cumsum(x, dim=-1)


def scan_linrec_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t with h_{-1} = 0, along the last axis, one
    step after another (the exact order of operations)."""
    h = torch.zeros_like(a[..., 0])
    out = torch.empty_like(a)
    for t in range(a.shape[-1]):
        h = a[..., t] * h + b[..., t]
        out[..., t] = h
    return out


def _linrec_combine(left, right):
    a_l, b_l = left
    a_r, b_r = right
    return a_l * a_r, a_r * b_l + b_r


def scan_linrec_assoc_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same recurrence as a parallel associative scan."""
    return associative_scan(_linrec_combine, (a, b), dim=-1)[1]
