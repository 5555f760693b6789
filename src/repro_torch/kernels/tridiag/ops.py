"""Tridiagonal solver library: PCR and Thomas (CUDA kernels), CR, LF, WM.

The PyTorch port of ``repro.kernels.tridiag.ops``.  The four parallel
variants mirror the BPLG solver family (paper §III):
  pcr — Parallel Cyclic Reduction, full-width log2(n) steps (the kernel);
  cr  — Cyclic Reduction, forward halving + back substitution;
  lf  — Ladner-Fischer: the LU-elimination recurrences recast as parallel
        prefixes (2x2 Mobius matrices for the pivots plus two linear-
        recurrence scans for the substitution sweeps); above
        ``LF_MULTIPASS_MIN`` the sweeps run on the tuned linrec kernels;
  wm  — Wang&Mou divide-and-conquer: the same prefix math evaluated chunk-
        wise (sequential inside a chunk of `radix * 16` elements, parallel
        across chunks) — the radix is the tunable fan-in, as in the paper.

``cr``, ``lf`` (up to ``LF_MULTIPASS_MIN``), ``wm`` and ``thomas`` are
plain XLA in the JAX package; here the first three are torch ops on the
input's device — the JAX package's own routing — and ``thomas``, whose
two ``lax.scan``s XLA runs as one device loop, is the CUDA kernel
``kernel.thomas`` on the card (its plan keeps JAX's empty launch list:
no Pallas launch).  ``solve(..., variant=...)``
resolves the configuration for the (op="tridiag", variant, n, batch)
workload through the TunerSession.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import telemetry
from repro_torch.core.space import Workload, fit_block, tridiag_space
from repro_torch.kernels.blocks import driver
from repro_torch.kernels.blocks.associative import associative_scan
from repro_torch.kernels.blocks.plan import plan_for, wm_chunk
from repro_torch.kernels.tridiag.kernel import pcr, thomas
from repro_torch.kernels.tridiag.ref import thomas_ref
from repro_torch.tuning import default_session, tuned_kernel

# systems longer than this route the LF substitution sweeps through the
# tuned linrec kernels (fused, or the §IV-C multipass path)
LF_MULTIPASS_MIN = 1 << 15


def _normalize(cfg, wl, dims=None):
    """Variant-aware projection onto the knobs each solver actually
    consumes, so the resolved config uniquely determines the executed
    kernel (what the TuningDB records is what ran):

      pcr         -> rows_per_program, unroll;
      wm          -> radix plus the DERIVED chunk (``blocks.plan.wm_chunk``);
      cr/lf/thomas -> no knobs (their spaces are singletons).
    """
    if wl.variant == "wm":
        radix = cfg.get("radix", 2)
        return {"radix": radix, "chunk": wm_chunk(radix, wl.n)}
    if wl.variant in ("cr", "lf", "thomas"):
        return {}
    return {"rows_per_program": fit_block(cfg.get("rows_per_program", 8),
                                          max(wl.batch, 1)),
            "unroll": cfg.get("unroll", 1)}


def _shift_right(v: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """v[..., i - 1] at i, ``fill`` at 0 (``jnp.pad(v[..., :-1], (1, 0))``)."""
    return F.pad(v[..., :-1], (1, 0), value=fill)


def _shift_left(v: torch.Tensor) -> torch.Tensor:
    """v[..., i + 1] at i, 0 at the end."""
    return F.pad(v[..., 1:], (0, 1))


# ---------------------------------------------------------------------------
# CR — cyclic reduction
# ---------------------------------------------------------------------------

def cr_solve(a, b, c, d):
    levels = []
    while a.shape[-1] > 2:
        am, bm, cm, dm = (_shift_right(v) for v in (a, b, c, d))
        bm[..., 0] = 1.0
        ap, bp, cp, dp = (_shift_left(v) for v in (a, b, c, d))
        bp[..., -1] = 1.0
        alpha = -a / bm
        gamma = -c / bp
        a2 = alpha * am
        b2 = b + alpha * cm + gamma * ap
        c2 = gamma * cp
        d2 = d + alpha * dm + gamma * dp
        levels.append((a, b, c, d))
        a, b, c, d = (v[..., 1::2] for v in (a2, b2, c2, d2))
    # solve the 2x2 (or 1x1) core directly
    if a.shape[-1] == 1:
        x = d / b
    else:
        det = b[..., 0] * b[..., 1] - c[..., 0] * a[..., 1]
        x0 = (d[..., 0] * b[..., 1] - c[..., 0] * d[..., 1]) / det
        x1 = (b[..., 0] * d[..., 1] - d[..., 0] * a[..., 1]) / det
        x = torch.stack([x0, x1], dim=-1)
    # back substitution
    for (a0, b0, c0, d0) in reversed(levels):
        xfull = torch.zeros_like(a0)
        xfull[..., 1::2] = x
        xm, xp = _shift_right(xfull), _shift_left(xfull)
        xeven = (d0 - a0 * xm - c0 * xp) / b0
        xfull[..., 0::2] = xeven[..., 0::2]
        x = xfull
    return x


# ---------------------------------------------------------------------------
# LF — parallel-prefix formulation
# ---------------------------------------------------------------------------

def _mobius_combine(x, y):
    # y (newer) @ x (older), normalized for scale stability
    y00, y01, y10, y11 = y
    x00, x01, x10, x11 = x
    z00 = y00 * x00 + y01 * x10
    z01 = y00 * x01 + y01 * x11
    z10 = y10 * x00 + y11 * x10
    z11 = y10 * x01 + y11 * x11
    s = torch.maximum(torch.maximum(z00.abs(), z01.abs()),
                      torch.maximum(z10.abs(), z11.abs())) + 1e-30
    return z00 / s, z01 / s, z10 / s, z11 / s


def _pivot_prefix(a, b, c):
    """LU pivots e_i via normalized 2x2 Mobius-matrix prefix products."""
    cm = _shift_right(c)
    m00 = b
    m01 = -a * cm
    m10 = torch.ones_like(b)
    m11 = torch.zeros_like(b)
    # first matrix encodes e_0 = b_0 directly: [b0, 0; 1, 0] works since
    # v_{-1} = [1, 0]^T  ->  v_0 = [b0, 1]^T (after the ratio, e_0 = b0).
    m01[..., 0] = 0.0
    p00, _, p10, _ = associative_scan(_mobius_combine, (m00, m01, m10, m11),
                                      dim=-1)
    # v_i = P_i [1, 0]^T = [p00, p10]
    return p00 / p10


def _linrec_combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _linrec(a, b, reverse=False):
    if reverse:
        a, b = torch.flip(a, [-1]), torch.flip(b, [-1])
    _, h = associative_scan(_linrec_combine, (a, b), dim=-1)
    return torch.flip(h, [-1]) if reverse else h


def _sweep_coefficients(a, b, c):
    """Pivots e and the forward sweep's multipliers alpha (alpha_0 = 0)."""
    e = _pivot_prefix(a, b, c)
    alpha = -a / _shift_right(e, fill=1.0)
    alpha[..., 0] = 0.0
    return e, alpha


def lf_solve(a, b, c, d):
    e, alpha = _sweep_coefficients(a, b, c)
    y = _linrec(alpha, d)                      # forward substitution
    return _linrec(-c / e, y / e, reverse=True)   # back substitution


def lf_solve_multipass(a, b, c, d):
    """LF with the substitution sweeps on the tuned linear recurrence.

    The pivot prefix stays the normalized 2x2 scan (scale stability), but
    the forward/back linear recurrences run as the shared carry-chain
    building block (``driver.linrec_rows``) — fused for small n, the
    §IV-C three-launch decomposition once the row exceeds the resident
    tile.
    """
    e, alpha = _sweep_coefficients(a, b, c)
    y = driver.linrec_rows(alpha, d)
    x = driver.linrec_rows(torch.flip(-c / e, [-1]), torch.flip(y / e, [-1]))
    return torch.flip(x, [-1])


# ---------------------------------------------------------------------------
# WM — divide-and-conquer (chunked prefix)
# ---------------------------------------------------------------------------

def _chunked_linrec(a, b, chunk: int, reverse=False):
    """linrec via sequential scan inside chunks + associative scan across."""
    if reverse:
        a, b = torch.flip(a, [-1]), torch.flip(b, [-1])
    batch, n = a.shape
    p = n // chunk
    ar = a.reshape(batch, p, chunk)
    br = b.reshape(batch, p, chunk)
    # within-chunk, with zero entry state: the local response and the
    # local cumulative products
    h_local = torch.empty_like(ar)
    h = torch.zeros_like(ar[..., 0])
    for i in range(chunk):
        h = ar[..., i] * h + br[..., i]
        h_local[..., i] = h
    a_cum = torch.cumprod(ar, dim=-1)
    # chunk transfer: state_out = A_chunk * state_in + B_chunk
    _, carry_in = associative_scan(_linrec_combine,
                                   (a_cum[..., -1], h_local[..., -1]), dim=-1)
    # entry state of chunk k = exit state of chunk k-1
    entry = _shift_right(carry_in)
    h = (h_local + a_cum * entry[..., None]).reshape(batch, n)
    return torch.flip(h, [-1]) if reverse else h


def wm_solve(a, b, c, d, chunk: int = 32):
    e, alpha = _sweep_coefficients(a, b, c)   # pivots via tree prefix
    y = _chunked_linrec(alpha, d, chunk)
    return _chunked_linrec(-c / e, y / e, chunk, reverse=True)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@tuned_kernel("tridiag", space=tridiag_space, kernel=pcr,
              reference=thomas_ref, normalize=_normalize,
              variants=("pcr", "cr", "lf", "wm", "thomas"))
@telemetry.spanned("repro.entry.solve")
def solve(a, b, c, d, variant: str = "pcr", config: Optional[dict] = None):
    """Tuned batched tridiagonal solve; x with A x = d."""
    batch, n = a.shape
    wl = Workload(op="tridiag", n=n, batch=batch, variant=variant)
    if variant == "pcr":
        cfg = default_session().resolve(wl, config=config)
        plan = plan_for(wl, cfg)
        return driver.launch(pcr, plan.launches[0], a, b, c, d,
                             rows_per_program=cfg["rows_per_program"],
                             unroll=cfg["unroll"])
    if variant == "cr":
        return cr_solve(a, b, c, d)
    if variant == "lf":
        if n > LF_MULTIPASS_MIN:
            return lf_solve_multipass(a, b, c, d)
        return lf_solve(a, b, c, d)
    if variant == "wm":
        cfg = default_session().resolve(wl, config=config)
        return wm_solve(a, b, c, d, chunk=cfg["chunk"])
    if variant == "thomas":
        return thomas(a, b, c, d)
    raise ValueError(f"unknown tridiag variant {variant!r}")
