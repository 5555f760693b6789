"""The RecurrentGemma recurrent block: a causal conv1d and the RG-LRU.

``RecurrentBlock`` is ``repro.models.recurrent.recurrent_block`` as an
``nn.Module`` whose parameters carry the JAX tree's names (``wx``, ``wy``,
``conv_w``, ``wa``, ``wi``, ``lambda``, ``wo``).  The block forms its own
gates, in f32, and hands the recurrence h_t = a_t h_{t-1} + b_t over
(B * W, L) rows to the tuned ``linear_recurrence`` (the hand-written
linrec kernels on the card), as the JAX block does; a one-token call with
a cache is the O(1) decode step a * state + b.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.hints import lowering
from repro_torch.kernels.scan.ops import linear_recurrence
from repro_torch.kernels.scan.ref import scan_linrec_assoc_ref
from repro_torch.models.layers import Dense, causal_conv1d, gelu

_C = 8.0  # RG-LRU decay sharpness (Griffin)


def _width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def lru_lambda(width: int) -> torch.Tensor:
    """softplus^-1 of the decay base: log(expm1(r^(-1/C) - 1)) for r evenly
    spaced over [0.9, 0.999], in f32 on the host (the same values on every
    device).  JAX's initializer computes the same expression; XLA's own
    linspace and expm1 on the CPU round differently in the last bits."""
    r = torch.linspace(0.9, 0.999, width, dtype=torch.float32)
    return torch.log(torch.expm1(r ** (-1.0 / _C) - 1.0))


class RecurrentBlock(nn.Module):
    """x: (B, L, D) -> (B, L, D); cache (decode): {"conv": (B, K-1, W),
    "state": (B, W) f32}."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        d, w = cfg.d_model, _width(cfg)
        self.wx = Dense(d, w, dtype, device)
        self.wy = Dense(d, w, dtype, device)          # gate branch
        self.conv_w = nn.Parameter(torch.zeros(cfg.conv_width, w,
                                               dtype=dtype, device=device))
        self.wa = Dense(w, w, dtype, device)          # recurrence gate
        self.wi = Dense(w, w, dtype, device)          # input gate
        # "lambda" is a keyword: registered by name, read with getattr
        self.register_parameter("lambda", nn.Parameter(torch.zeros(
            w, dtype=torch.float32, device=device)))
        self.wo = Dense(w, d, dtype, device)

    def reset(self, generator: torch.Generator) -> None:
        """Normal projections over sqrt(fan-in), a normal conv over
        sqrt(conv_width) (the JAX ``init_recurrent_block`` scales), and the
        deterministic ``lambda``."""
        k = self.conv_w.shape[0]
        with torch.no_grad():
            self.wx.reset(generator)
            self.wy.reset(generator)
            self.conv_w.copy_(torch.randn(self.conv_w.shape,
                                          generator=generator,
                                          device=self.conv_w.device)
                              * (1.0 / math.sqrt(k)))
            self.wa.reset(generator)
            self.wi.reset(generator)
            lam = getattr(self, "lambda")
            lam.copy_(lru_lambda(lam.shape[0]).to(lam.device))
            self.wo.reset(generator)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[Dict] = None,
                compute_dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        bsz, L, _ = x.shape
        cd = compute_dtype
        u = self.wx(x, cd)
        gate = gelu(self.wy(x, cd))
        u, conv_cache = causal_conv1d(
            u, self.conv_w.to(cd),
            cache=None if cache is None else cache["conv"])

        r = torch.sigmoid(self.wa(u, torch.float32))
        i = torch.sigmoid(self.wi(u, torch.float32))
        log_a = -_C * F.softplus(getattr(self, "lambda"))[None, None, :] * r
        a = torch.exp(log_a)                                    # (B, L, W)
        gated = i * u.to(torch.float32)
        # 1 - a^2 = -expm1(2 log_a): exact as a -> 1
        b = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12)) \
            * gated

        if cache is None or L > 1:
            W = a.shape[-1]
            a_rows = a.transpose(1, 2).reshape(bsz * W, L)
            b_rows = b.transpose(1, 2).reshape(bsz * W, L)
            h = _recurrence(a_rows, b_rows, cfg)
            h = h.reshape(bsz, W, L).transpose(1, 2)
            new_state = h[:, -1]
        else:
            h = a[:, 0] * cache["state"] + b[:, 0]              # (B, W)
            new_state = h
            h = h[:, None]

        y = self.wo(h.to(cd) * gate, cd)
        new_cache = None
        if cache is not None:
            new_cache = {"conv": conv_cache.to(cache["conv"].dtype),
                         "state": new_state}
        return y, new_cache


def _recurrence(a: torch.Tensor, b: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """The JAX block's ``linear_recurrence(..., use_pallas=cfg.use_pallas
    or None)``: the tuned entry point on the card whatever ``use_pallas``
    says (the kernels), and on the CPU only when it is set (the plan's
    plain versions; a DTensor with real data raises there); otherwise, and
    on a lowering (fake tensors: the dry-run), the associative-scan
    reference."""
    if not lowering(a) and (a.is_cuda or cfg.use_pallas):
        return linear_recurrence(a, b)
    return scan_linrec_assoc_ref(a, b)


def init_recurrent_cache(cfg: ModelConfig, batch: int,
                         dtype: torch.dtype = torch.float32,
                         device=None) -> Dict:
    w = _width(cfg)
    return {"conv": torch.zeros(batch, cfg.conv_width - 1, w, dtype=dtype,
                                device=device),
            "state": torch.zeros(batch, w, dtype=torch.float32,
                                 device=device)}
