"""Oracle for the RG-LRU (Real-Gated Linear Recurrent Unit) core, as
``repro.kernels.rglru.ref`` defines it.

Given per-position per-channel decay a in (0, 1) and gated input u:
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * u_t
(De et al., RecurrentGemma / Griffin).  Shapes: (B, L, D).
"""
from __future__ import annotations

import torch


def rglru_ref(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One step after another, in the inputs' type."""
    h = torch.zeros_like(a[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        a_t = a[:, t]
        h = a_t * h + torch.sqrt(torch.clamp_min(1.0 - a_t * a_t, 0.0)) \
            * u[:, t]
        out[:, t] = h
    return out
