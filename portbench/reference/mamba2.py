"""The Mamba-2 language model as the configuration file states it, in
plain float32 PyTorch with TF32 off, one prompt at a time; its weights,
drawn from the seed; and its control.

The forward follows the port's block (the configuration's
``departures``): embedding times sqrt(d_model); per layer a residual
x + out_proj(rms_norm(y * silu(z)) (1 + norm)) where in_proj splits
rms_norm(x) (1 + ln) into x, z, b, c and dt_raw, a depthwise causal conv
and silu act on [x, b, c], dt = softplus(dt_raw + dt_bias), a =
exp(-exp(a_log) dt), and y is the state-space recurrence h_t = a_t h_{t-1}
+ b_t x_t^T, y_t = h_t^T c_t per head; the final norm and the tied
unembedding.  The recurrence runs chunked (the SSD's quadratic form inside
a chunk of 64, the states carried between chunks), its decays from log a
summed in float64.

The control puts the model at the precision one step below what the
configuration states, as a later change might: every value the
configuration computes in bf16 (weights, activations, the residual
stream) on float8 e4m3 with one scale a tensor, and every value it
computes in float32 (dt, the decays, the SSD's output, the logits) on
bfloat16.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict

import torch
import torch.nn.functional as F


def dims(cfg: Dict):
    d_inner = cfg["expand"] * cfg["d_model"]
    return d_inner, d_inner // cfg["headdim"], cfg["headdim"], cfg["d_state"]


def vocab_rows(cfg: Dict) -> int:
    """Rows of the embedding and the tied unembedding: ``vocab_size``
    padded up to a multiple of ``pad_vocab_size_multiple``, as the released
    weights have them."""
    m = cfg["pad_vocab_size_multiple"]
    return -(-cfg["vocab_size"] // m) * m


def draw(cfg: Dict, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Weights in the types they are served in (bf16; a_log and dt_bias
    float32), drawn on ``gen``'s device in a few large calls: projections
    and embedding N(0, 1) / sqrt(fan-in), the out projection also over
    sqrt(n_layer), conv N(0, 1) / sqrt(width), norm
    scales 0.1 N(0, 1), a_log = log U[1, 16), dt_bias the inverse softplus
    of dt log-uniform in [0.001, 0.1)."""
    dev, bf = gen.device, getattr(torch, cfg["param_dtype"])
    n, d, v, k = cfg["n_layer"], cfg["d_model"], vocab_rows(cfg), \
        cfg["d_conv"]
    d_inner, h, _, s = dims(cfg)
    d_in = 2 * d_inner + 2 * cfg["ngroups"] * s + h
    chan = d_inner + 2 * cfg["ngroups"] * s
    # the out projection also over sqrt(n_layer): the published model's
    # residual rescale at initialization (mamba_ssm's
    # rescale_prenorm_residual)
    shapes = {"embed": ((v, d), d), "in_proj": ((n, d, d_in), d),
              "out_proj": ((n, d_inner, d), d_inner * n),
              "conv": ((n, k, chan), k)}
    total = sum(math.prod(shape) for shape, _ in shapes.values())
    flat = torch.randn(total, generator=gen, device=dev)
    w, at = {}, 0
    for name, (shape, fan_in) in shapes.items():
        size = math.prod(shape)
        w[name] = (flat[at:at + size].view(shape)
                   * (1.0 / math.sqrt(fan_in))).to(bf)
        at += size
    del flat
    norms = 0.1 * torch.randn(n * d + n * d_inner + d, generator=gen,
                              device=dev)
    w["ln"] = norms[:n * d].view(n, d).to(bf)
    w["norm"] = norms[n * d:n * d + n * d_inner].view(n, d_inner).to(bf)
    w["final_norm"] = norms[n * d + n * d_inner:].to(bf)
    u = torch.rand(2, n, h, generator=gen, device=dev)
    w["a_log"] = torch.log(1.0 + 15.0 * u[0])
    dt = torch.exp(math.log(1e-3) + (math.log(1e-1) - math.log(1e-3)) * u[1])
    w["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    return w


@contextmanager
def exact_f32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` on float8 e4m3 with one scale for the tensor, back in f32."""
    scale = t.abs().max().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        chunk: int = 64) -> torch.Tensor:
    """y_t = h_t^T c_t with h_t = a_t h_{t-1} + b_t x_t^T, h_0 = 0; x (L,
    H, P), a (L, H) in (0, 1], b and c (L, S); y (L, H, P)."""
    L, H, P = x.shape
    q = chunk if L % chunk == 0 else L
    nc = L // q
    la = torch.log(a.double().clamp_min(torch.finfo(torch.float32).tiny))
    cum = torch.cumsum(la.view(nc, q, H), dim=1)                 # (nc, q, H)
    seg = cum[:, :, None, :] - cum[:, None, :, :]                # t, s
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[None, :, :, None],
                                      float("-inf"))).float()
    xc, bc, cc = x.view(nc, q, H, P), b.view(nc, q, -1), c.view(nc, q, -1)
    cb = torch.einsum("nts,nus->ntu", cc, bc)                    # (nc, q, q)
    y = torch.einsum("ntuh,nuhp->nthp", decay * cb[..., None], xc)
    to_end = torch.exp(cum[:, -1:, :] - cum).float()             # (nc, q, H)
    states = torch.einsum("nuh,nus,nuhp->nhsp", to_end, bc, xc)
    across = torch.exp(cum[:, -1, :]).float()                    # (nc, H)
    entry = torch.zeros_like(states[0])
    entries = []
    for i in range(nc):
        entries.append(entry)
        entry = across[i][:, None, None] * entry + states[i]
    entries = torch.stack(entries)                               # (nc,H,S,P)
    y = y + torch.einsum("nth,nts,nhsp->nthp", torch.exp(cum).float(), cc,
                         entries)
    return y.reshape(L, H, P)


def forward(w: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: Dict,
            control: bool = False):
    """(logits (L, V) in float32, conditioning (L,)) of one prompt
    ``tokens`` (L,).  A position's conditioning is the least, over the
    layers, of its gated-norm input's root mean square over the median
    position's: where it is small the norm divides by nearly nothing and
    magnifies any rounding before it.

    ``lo`` marks each value the configuration computes in its compute type
    (bf16) and ``hi`` each it computes in float32: both the identity here,
    float8 and bfloat16 in the control."""
    d_inner, h, p, s = dims(cfg)
    eps, k = cfg["rms_norm_eps"], cfg["d_conv"]
    gs = cfg["ngroups"] * s
    lo = _fp8 if control else (lambda t: t)
    hi = _bf16 if control else (lambda t: t)
    with exact_f32():
        x = lo(w["embed"][tokens].float() * math.sqrt(cfg["d_model"]))
        L = x.shape[0]
        cond = torch.full((L,), float("inf"), device=x.device)
        for i in range(cfg["n_layer"]):
            u = lo(_rms(x, w["ln"][i], eps))
            z_all = lo(u @ lo(w["in_proj"][i].float()))
            xs, z, bc, dt_raw = torch.split(
                z_all, [d_inner, d_inner, 2 * gs, h], dim=-1)
            conv_in = torch.cat([xs, bc], dim=-1)               # (L, chan)
            cw = lo(w["conv"][i].float())
            padded = torch.cat([conv_in.new_zeros(k - 1, conv_in.shape[1]),
                                conv_in])
            conv = lo(sum(padded[j:j + L] * cw[j] for j in range(k)))
            conv = lo(_silu(conv))
            xs, b, c = torch.split(conv, [d_inner, gs, gs], dim=-1)
            dt = hi(F.softplus(dt_raw + hi(w["dt_bias"][i])))
            a = hi(torch.exp(-torch.exp(hi(w["a_log"][i])) * dt))
            y = lo(hi(ssd(xs.reshape(L, h, p), a, b, c)))
            g = lo(y.reshape(L, d_inner) * lo(_silu(z)))
            g_rms = g.square().mean(-1).sqrt()
            cond = torch.minimum(cond, g_rms / g_rms.median().clamp_min(
                torch.finfo(torch.float32).tiny))
            y = lo(_rms(g, w["norm"][i], eps))
            x = lo(x + lo(y @ lo(w["out_proj"][i].float())))
        x = lo(_rms(x, w["final_norm"], eps))
        return hi(hi(x) @ hi(w["embed"].float()).t()), cond
