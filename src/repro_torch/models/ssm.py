"""The Mamba-2 (SSD) block — the model-level caller of the tuned SSD op.

``SSDBlock`` is ``repro.models.ssm.ssd_block`` as an ``nn.Module``: its
parameters carry the JAX parameter tree's names (``in_proj.w``,
``conv_w``, ``a_log``, ``dt_bias``, ``norm_scale``, ``out_proj.w``), so
``models.convert`` loads a JAX block's parameters into it, and
``SSDBlock.init`` draws fresh ones at the JAX initializer's scales from a
``torch.Generator``.  Prefill runs the SSD op (the hand-written kernels
on the card); a one-token call with a cache is the O(1) decode step.
With ``published`` the block is the published Mamba-2 mixer: the conv
has a bias (``conv_b``), the SSD's input is x scaled by dt, and a skip
D x a head (``d_skip``, f32) joins its output.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.space import Workload
from repro_torch.distributed.hints import lowering, merged, splittable
from repro_torch.kernels.ssd.ops import ssd as ssd_op
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from repro_torch.models.layers import Dense, causal_conv1d, rms_norm, silu


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state


class SSDBlock(nn.Module):
    """x: (B, L, D) -> (B, L, D); cache (decode): {"conv": (B, K-1, chan),
    "state": (B, H, S, P)}."""

    def __init__(self, cfg: ModelConfig, dtype: Optional[torch.dtype] = None,
                 device=None, published: bool = False):
        super().__init__()
        d_inner, n_heads, s = _dims(cfg)
        d = cfg.d_model
        dtype = dtype if dtype is not None else getattr(torch, cfg.param_dtype)
        self.cfg = cfg
        self.published = published
        # fused input projection: [x (d_inner), z (d_inner), B (s), C (s),
        # dt (H)]
        self.in_proj = Dense(d, 2 * d_inner + 2 * s + n_heads, dtype, device)
        self.conv_w = nn.Parameter(torch.zeros(
            cfg.conv_width, d_inner + 2 * s, dtype=dtype, device=device))
        self.a_log = nn.Parameter(torch.zeros(n_heads, dtype=torch.float32,
                                              device=device))
        self.dt_bias = nn.Parameter(torch.zeros(n_heads, dtype=torch.float32,
                                                device=device))
        self.norm_scale = nn.Parameter(torch.zeros(d_inner, dtype=dtype,
                                                   device=device))
        self.out_proj = Dense(d_inner, d, dtype, device)
        if published:
            self.conv_b = nn.Parameter(torch.zeros(
                d_inner + 2 * s, dtype=dtype, device=device))
            self.d_skip = nn.Parameter(torch.zeros(
                n_heads, dtype=torch.float32, device=device))

    @classmethod
    def init(cls, cfg: ModelConfig, generator: torch.Generator,
             dtype: Optional[torch.dtype] = None, device=None) -> "SSDBlock":
        """A block with weights drawn from ``generator`` (on ``device``) at
        the scales of the JAX ``init_ssd_block``: normal projections over
        sqrt(fan-in), a normal conv over sqrt(width), a_log = log(linspace(1,
        16, H)), zero dt bias and norm scale; published, a zero conv bias
        and D = 1 (the published mixer's initialization)."""
        block = cls(cfg, dtype=dtype, device=device)
        block.reset(generator)
        return block

    def reset(self, generator: torch.Generator) -> None:
        """Draw this block's weights from ``generator`` (see ``init``)."""
        _, n_heads, _ = _dims(self.cfg)
        with torch.no_grad():
            self.in_proj.reset(generator)
            self.conv_w.copy_(torch.randn(
                self.conv_w.shape, generator=generator,
                device=self.conv_w.device)
                * (1.0 / math.sqrt(self.cfg.conv_width)))
            self.a_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, n_heads, dtype=torch.float32,
                device=self.a_log.device)))
            self.dt_bias.zero_()
            self.norm_scale.zero_()
            self.out_proj.reset(generator)
            if self.published:
                self.conv_b.zero_()
                self.d_skip.fill_(1.0)

    def ssd_inputs(self, x: torch.Tensor, cache: Optional[Dict] = None,
                   compute_dtype: torch.dtype = torch.bfloat16):
        """Everything before the SSD core: (xh (B, L, H, P), a (B, L, H) f32,
        b, c (B, L, S), the gate z, the new conv cache)."""
        return self._inputs(x, cache, compute_dtype)[:6]

    def _inputs(self, x: torch.Tensor, cache: Optional[Dict],
                compute_dtype: torch.dtype):
        """``ssd_inputs`` and dt (B, L, H) f32."""
        cfg = self.cfg
        bsz, L, _ = x.shape
        d_inner, n_heads, s = _dims(cfg)
        proj = self.in_proj(x, compute_dtype)
        xz, z, bc, dt_raw = torch.split(proj, [d_inner, d_inner, 2 * s,
                                               n_heads], dim=-1)
        conv_in = torch.cat([xz, bc], dim=-1)
        conv_out, conv_cache = causal_conv1d(
            conv_in, self.conv_w.to(compute_dtype),
            cache=None if cache is None else cache["conv"])
        if self.published:
            conv_out = conv_out + self.conv_b.to(compute_dtype)
        conv_out = silu(conv_out)
        xs, b_in, c_in = torch.split(conv_out, [d_inner, s, s], dim=-1)
        dt = F.softplus(dt_raw.to(torch.float32)
                        + self.dt_bias[None, None, :])              # (B, L, H)
        a = torch.exp(-torch.exp(self.a_log)[None, None, :] * dt)  # in (0, 1)
        xh = splittable(xs, -1, n_heads).reshape(bsz, L, n_heads,
                                                 cfg.ssm_head_dim)
        return xh, a, b_in, c_in, z, conv_cache, dt

    def forward(self, x: torch.Tensor, cache: Optional[Dict] = None,
                compute_dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        cfg = self.cfg
        bsz, L, _ = x.shape
        d_inner, n_heads, _ = _dims(cfg)
        xh, a, b_in, c_in, z, conv_cache, dt = self._inputs(x, cache,
                                                            compute_dtype)
        x_in = xh.to(torch.float32)
        if self.published:
            x_in = x_in * dt[..., None]
        if cache is None or L > 1:
            y = _ssd(x_in, a, b_in.to(torch.float32), c_in.to(torch.float32))
            new_state = None  # prefill state capture: decode from scratch
        else:
            # O(1) decode step: h = a h + b x^T ; y = c . h
            h = cache["state"]
            x_t = x_in[:, 0]                                       # (B, H, P)
            a_t = a[:, 0]                                          # (B, H)
            b_t = b_in[:, 0].to(torch.float32)                     # (B, S)
            c_t = c_in[:, 0].to(torch.float32)
            h = a_t[..., None, None] * h \
                + torch.einsum("bs,bhp->bhsp", b_t, x_t)
            y = torch.einsum("bs,bhsp->bhp", c_t, h)[:, None]      # (B,1,H,P)
            new_state = h
        if self.published:
            y = y + self.d_skip[:, None] * xh.to(torch.float32)

        y = merged(y.reshape(bsz, L, d_inner), n_heads).to(compute_dtype)
        y = rms_norm(y * silu(z), self.norm_scale, cfg.norm_eps)
        out = self.out_proj(y, compute_dtype)
        new_cache = None
        if cache is not None:
            new_cache = {"conv": conv_cache.to(cache["conv"].dtype),
                         "state": new_state if new_state is not None
                         else cache["state"]}
        return out, new_cache


def _ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         c: torch.Tensor) -> torch.Tensor:
    """The JAX block's ``ssd(...)``: the tuned op (the kernels on the card,
    their plain versions on the CPU; a DTensor with real data raises there),
    and on a lowering (fake tensors: the dry-run) the chunked reference at
    the session's chunk, as the JAX op runs on its CPU backend and JAX's
    dry-run lowers it."""
    if not lowering(x):
        return ssd_op(x, a, b, c)
    from repro_torch.tuning import default_session

    B, L, H, _ = x.shape
    wl = Workload(op="ssd", n=L, batch=B * H, variant="chunked")
    chunk = default_session().resolve(wl)["chunk"]
    return ssd_chunked_ref(x, a, b, c, chunk=chunk)


def init_ssd_cache(cfg: ModelConfig, batch: int,
                   dtype: torch.dtype = torch.float32, device=None) -> Dict:
    d_inner, n_heads, s = _dims(cfg)
    chan = d_inner + 2 * s
    return {
        "conv": torch.zeros(batch, cfg.conv_width - 1, chan, dtype=dtype,
                            device=device),
        "state": torch.zeros(batch, n_heads, s, cfg.ssm_head_dim,
                             dtype=torch.float32, device=device),
    }
