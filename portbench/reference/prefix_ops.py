"""References of the paper's prefix operations on (batch, n) rows, and
their controls.

The reference computes in float64 (complex128 for the FFT).  The control
is the same computation at bfloat16, one step below the float32 the
configuration states: its inputs and its output rounded to bfloat16 (a
true bfloat16 computation rounds more often, so this control is the
harder one to catch).
"""
from __future__ import annotations

import torch


def scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of each row."""
    return torch.cumsum(x.to(torch.float64), dim=-1)


def tridiag(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            d: torch.Tensor) -> torch.Tensor:
    """x with a_j x_{j-1} + b_j x_j + c_j x_{j+1} = d_j in each row: the
    sequential Thomas algorithm in float64.  a[:, 0] and c[:, -1] lie
    outside the system and are never read."""
    at, bt, ct, dt = (v.to(torch.float64).t().contiguous()
                      for v in (a, b, c, d))
    n = at.shape[0]
    cp = torch.empty_like(ct)
    dp = torch.empty_like(dt)
    cp[0] = ct[0] / bt[0]
    dp[0] = dt[0] / bt[0]
    for j in range(1, n):
        denom = bt[j] - at[j] * cp[j - 1]
        cp[j] = ct[j] / denom
        dp[j] = (dt[j] - at[j] * dp[j - 1]) / denom
    x = torch.empty_like(dt)
    x[n - 1] = dp[n - 1]
    for j in range(n - 2, -1, -1):
        x[j] = dp[j] - cp[j] * x[j + 1]
    return x.t()


def fft(x: torch.Tensor) -> torch.Tensor:
    """The forward DFT of each row, e^{-2 pi i jk / n}."""
    return torch.fft.fft(x.to(torch.complex128), dim=-1)


REFERENCES = {"scan": scan, "tridiag": tridiag, "fft": fft,
              "large_fft": fft}


def to_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (real and imaginary parts apart), in its
    own type."""
    if t.is_complex():
        return torch.view_as_complex(
            torch.view_as_real(t).to(torch.bfloat16).to(
                torch.view_as_real(t).dtype).contiguous())
    return t.to(torch.bfloat16).to(t.dtype)


def reference(family: str, inputs):
    return REFERENCES[family](*inputs)


def control(family: str, inputs):
    """The reference at bfloat16: inputs and output rounded to it."""
    return to_bf16(REFERENCES[family](*(to_bf16(v) for v in inputs)))


def max_err(got: torch.Tensor, ref: torch.Tensor):
    """(largest |got - ref|, largest |ref|) over the rows given."""
    diff = got.to(ref.dtype) - ref
    return float(diff.abs().max()), float(ref.abs().max())
