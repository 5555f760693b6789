"""Oracles for the complex FFT kernels, as ``repro.kernels.fft.ref``
defines them (tests and ``chip_smoke.py`` only; the entry points never call
them)."""
from __future__ import annotations

import cmath
import math

import torch


def fft_ref(x: torch.Tensor) -> torch.Tensor:
    """Row-wise complex DFT via ``torch.fft.fft`` (x: (..., n) complex)."""
    return torch.fft.fft(x, dim=-1)


def stockham_plain(x: torch.Tensor, radix: int = 2) -> torch.Tensor:
    """Self-sorting Stockham DIF in plain complex arithmetic, the
    counterpart of ``stockham_jnp``: it validates the staged formulation
    the kernel computes on interleaved complex rows."""
    rows, n = x.shape
    buf = x
    n_cur, s = n, 1
    while n_cur > 1:
        rr = min(radix, n_cur)
        m = n_cur // rr
        v = buf.reshape(rows, n_cur, s)
        parts = [v[:, k * m:(k + 1) * m, :] for k in range(rr)]
        p = torch.arange(m, device=x.device).reshape(1, m, 1)
        outs = []
        for j in range(rr):
            t = sum(parts[k] * cmath.exp(-2j * math.pi * j * k / rr)
                    for k in range(rr))
            t = t * torch.exp(-2j * math.pi * j * p / n_cur)
            outs.append(t)
        buf = torch.stack(outs, dim=2).reshape(rows, n)
        n_cur, s = m, s * rr
    return buf


def four_step_ref(x: torch.Tensor, n1: int) -> torch.Tensor:
    """Four-step (Bailey) large FFT oracle: N = n1 * n2.

    View each row as (n2, n1), FFT the columns (length n2), twiddle, FFT
    the rows (length n1), transpose (the self-sort).
    """
    rows, n = x.shape
    n2 = n // n1
    v = x.reshape(rows, n2, n1)
    v = torch.fft.fft(v, dim=1)                      # length-n2 FFTs
    k2 = torch.arange(n2, device=x.device).reshape(1, n2, 1)
    k1 = torch.arange(n1, device=x.device).reshape(1, 1, n1)
    v = v * torch.exp(-2j * math.pi * (k1 * k2).to(x.dtype) / n)  # twiddle
    v = torch.fft.fft(v, dim=2)                      # length-n1 FFTs
    v = v.transpose(1, 2)                            # self-sort
    return v.reshape(rows, n)
