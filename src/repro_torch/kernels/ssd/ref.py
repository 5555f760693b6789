"""Oracles for the Mamba-2 SSD (state-space dual) core, as
``repro.kernels.ssd.ref`` defines them.

Per (batch, head): state h in R^{d_state x d_head}; for t = 1..L:
    h_t = a_t * h_{t-1} + b_t x_t^T        (a_t scalar decay per head-step)
    y_t = c_t^T h_t
with b_t, c_t in R^{d_state}, x_t in R^{d_head}.

Shapes (grouped layout, n_groups=1):
    x: (B, L, H, P)   a: (B, L, H)   b: (B, L, S)   c: (B, L, S)
    y: (B, L, H, P)

``ssd_ref`` is the sequential ground truth (in float64 on the card, it is
what ``chip_smoke.py`` holds the op to); ``ssd_chunked_ref`` is the
chunked formulation the kernels implement, in plain tensor ops.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.blocks.associative import associative_scan


def ssd_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """One step after another, in the inputs' type."""
    B, L, H, P = x.shape
    S = b.shape[-1]
    h = torch.zeros(B, H, S, P, dtype=x.dtype, device=x.device)
    ys = torch.empty_like(x)
    for t in range(L):
        h = a[:, t, :, None, None] * h \
            + torch.einsum("bs,bhp->bhsp", b[:, t], x[:, t])
        ys[:, t] = torch.einsum("bs,bhsp->bhp", c[:, t], h)
    return ys


def _combine(left, right):
    al, sl = left
    ar, sr = right
    # the scanned (chunk) axis is last: a (B, H, m), s (B, H, S, P, m)
    return al * ar, ar[..., None, None, :] * sl + sr


def ssd_chunked_ref(x, a, b, c, chunk: int = 64):
    """Chunked (quadratic-intra + scanned-inter) formulation.

      intra: y_intra[t] = sum_{s<=t, same chunk} (prod_{u in (s,t]} a_u)
                          * (c_t . b_s) * x_s
      inter: chunk states scanned with the linear-recurrence monoid, then
             broadcast into each chunk through the decay prefix.
    """
    B, L, H, P = x.shape
    S = b.shape[-1]
    Q = chunk
    nc = L // Q
    xc = x.reshape(B, nc, Q, H, P)
    ac = a.reshape(B, nc, Q, H)
    bc = b.reshape(B, nc, Q, S)
    cc = c.reshape(B, nc, Q, S)

    # cumulative log-decay within chunk: A[t] = prod_{u<=t} a_u
    la = torch.cumsum(torch.log(torch.clamp_min(ac, 1e-30)), dim=2)
    A = torch.exp(la)
    # decay from s+1..t: A[t]/A[s], the mask applied inside the exp
    diff = la[:, :, :, None, :] - la[:, :, None, :, :]            # (B,nc,t,s,H)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    ratio = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  torch.full_like(diff, -1e30)))
    cb = torch.einsum("bnts,bnqs->bntq", cc, bc)                   # (B,nc,t,s)
    y_intra = torch.einsum("bntq,bntqh,bnqhp->bnthp", cb, ratio, xc)

    # chunk-exit states: sum_s (prod_{u>s} a) b_s x_s^T
    decay_to_end = torch.exp(la[:, :, -1:, :] - la)                # (B,nc,Q,H)
    state = torch.einsum("bnqs,bnqh,bnqhp->bnhsp", bc, decay_to_end, xc)
    a_chunk = A[:, :, -1, :]                                       # (B,nc,H)

    # inter-chunk linear recurrence over the chunk index
    _, s_scan = associative_scan(
        _combine, (a_chunk.permute(0, 2, 1),
                   state.permute(0, 2, 3, 4, 1)), dim=-1)          # (B,H,S,P,nc)
    s_scan = s_scan.permute(0, 4, 1, 2, 3)                         # (B,nc,H,S,P)
    entry = torch.cat([torch.zeros_like(s_scan[:, :1]), s_scan[:, :-1]],
                      dim=1)                                       # state entering chunk

    # inter contribution: y[t] += c_t . (A[t] * entry)
    y_inter = torch.einsum("bnqs,bnqh,bnhsp->bnqhp", cc, A, entry)
    return (y_intra + y_inter).reshape(B, L, H, P)
