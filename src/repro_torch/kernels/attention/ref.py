"""Oracle: standard softmax attention (causal / local-window / full), as
``repro.kernels.attention.ref`` defines it."""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (BH, Lq, D), k/v: (BH, Lk, D) -> (BH, Lq, D).

    When Lq < Lk the queries are assumed to be the *last* Lq positions
    (decode with a KV cache).  Scores are products in the input type, then
    f32; masked scores are -inf, so a row with no visible key is NaN; the
    probabilities are cast back to the input type before the product with
    v.  The default scale is 1 / sqrt(D) with sqrt(D) rounded to the input
    type first, as the JAX oracle computes it."""
    BH, Lq, D = q.shape
    Lk = k.shape[1]
    if scale is None:
        root = torch.tensor(math.sqrt(D), dtype=torch.float32).to(q.dtype)
        scale = (1.0 / root).to(device=q.device)
    s = torch.einsum("bqd,bkd->bqk", q, k).to(torch.float32) * scale
    qpos = torch.arange(Lq, device=q.device) + (Lk - Lq)
    kpos = torch.arange(Lk, device=q.device)
    mask = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask[None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(q.dtype), v)
