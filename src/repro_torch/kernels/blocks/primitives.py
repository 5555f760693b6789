"""In-kernel building blocks, in plain PyTorch.

The PyTorch counterparts of ``repro.kernels.blocks.primitives``:
``shift_lanes``, the balanced ``_tree_fold``, one radix-r ``shift_fold``
level (prefix sum), one ``linrec_level`` (the linear-recurrence pair
monoid), one Stockham ``butterfly`` stage (the complex FFT fold), one
``pcr_step`` (the tridiagonal fold), the RG-LRU input gate and the
cross-tile carry chains.  They are the plain versions of the CUDA
kernels' bodies (``csrc/scan.cu``, ``csrc/linrec.cu``, ``csrc/fft.cu``,
``csrc/tridiag.cu``): the same stage sequence, the same neighbour fill,
the same fold order, one rounding per multiply and add, so a kernel and
its plain version compute the same numbers in the same order (the FFT's
twiddle cos/sin aside: libdevice and PyTorch may differ by an ulp).  Stage
sequences come from
``repro_torch.kernels.blocks.plan.stage_radices`` — never recompute them
here.
"""
from __future__ import annotations

import math
import struct
from typing import List, Tuple

import torch


def shift_lanes(x: torch.Tensor, off: int, fill: float) -> torch.Tensor:
    """Shift the trailing dim by ``off`` lanes, filling with the monoid
    identity.  off > 0 shifts right (element i sees neighbour i - off),
    off < 0 shifts left."""
    if off == 0:
        return x
    pad = torch.full(x.shape[:-1] + (abs(off),), fill, dtype=x.dtype,
                     device=x.device)
    if off > 0:
        return torch.cat([pad, x[..., :-off]], dim=-1)
    return torch.cat([x[..., -off:], pad], dim=-1)


def _tree_fold(parts: List[torch.Tensor]) -> torch.Tensor:
    """Balanced pairwise reduction: neighbours pair up level by level, an
    odd last part passes through to the next level."""
    while len(parts) > 1:
        nxt = []
        for i in range(0, len(parts) - 1, 2):
            nxt.append(parts[i] + parts[i + 1])
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def shift_fold(x: torch.Tensor, fan_in: int, stride: int, *,
               fill: float = 0.0, unroll: int = 1) -> torch.Tensor:
    """One stage of a radix-``fan_in`` prefix circuit: fold the fan_in - 1
    shifted neighbours at multiples of ``stride`` into every element —
    one after another for ``unroll == 1``, as a balanced tree otherwise."""
    tile_n = x.shape[-1]
    shifted = [shift_lanes(x, k * stride, fill) for k in range(1, fan_in)
               if k * stride < tile_n]
    if not shifted:
        return x
    if unroll > 1:
        return x + _tree_fold(shifted)
    acc = x
    for sh in shifted:
        acc = acc + sh
    return acc


def linrec_level(aa: torch.Tensor, bb: torch.Tensor, fan_in: int,
                 stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stage for the linear-recurrence pair monoid.

    Composition (a, b)_new after (a, b)_old is (a_o * a_n, a_n * b_o + b_n);
    the fold order is fixed by the algebra (k = 1 .. fan_in - 1: first
    acc_b = acc_a * sb + acc_b, then acc_a = acc_a * sa), so there is no
    unroll knob.  Off the row's start the identity a = 1, b = 0 is read.
    """
    tile_n = aa.shape[-1]
    acc_a, acc_b = aa, bb
    for k in range(1, fan_in):
        off = k * stride
        if off >= tile_n:
            break
        sa = shift_lanes(aa, off, 1.0)
        sb = shift_lanes(bb, off, 0.0)
        acc_b = acc_a * sb + acc_b
        acc_a = acc_a * sa
    return acc_a, acc_b


def round_f32(v: float) -> float:
    """``v`` rounded to the nearest float32 (as JAX rounds a Python float
    that meets a float32 array)."""
    return struct.unpack("f", struct.pack("f", v))[0]


def cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def butterfly(re: torch.Tensor, im: torch.Tensor, *, n: int, n_cur: int,
              s: int, rr: int, sign: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One radix-``rr`` Stockham stage on (rows, n) split f32 planes.

    The planes are viewed as (rows, n_cur, s), split into rr parts of
    m = n_cur // rr; output j of part position p is the rr-point DFT
    ``sum_k x[(k m + p) s + q] w^(j k)``, summed over k in order
    (``tr += pr wr - pi wi``), times the twiddle exp(i theta_j p) with
    ``theta_j p`` and its cos/sin in f32; it lands at ``(p rr + j) s + q``
    — the radix digit innermost, the self-sorting layout.  ``rr`` must
    divide ``n_cur``; plans built from ``stage_radices`` guarantee it.
    """
    rows = re.shape[0]
    assert n_cur % rr == 0, (n_cur, rr)
    m = n_cur // rr
    vr = re.reshape(rows, n_cur, s)
    vi = im.reshape(rows, n_cur, s)
    parts = [(vr[:, k * m:(k + 1) * m, :], vi[:, k * m:(k + 1) * m, :])
             for k in range(rr)]
    p = torch.arange(m, dtype=torch.float32, device=re.device).reshape(
        1, m, 1)
    out_r = torch.empty(rows, m, rr, s, dtype=torch.float32, device=re.device)
    out_i = torch.empty_like(out_r)
    for j in range(rr):
        tr = torch.zeros(rows, m, s, dtype=torch.float32, device=re.device)
        ti = torch.zeros_like(tr)
        for k in range(rr):
            # the DFT weight in float64, each part rounded to f32
            ang = sign * 2.0 * math.pi * ((j * k) % rr) / rr
            wr, wi = round_f32(math.cos(ang)), round_f32(math.sin(ang))
            pr, pi_ = parts[k]
            tr = tr + (pr * wr - pi_ * wi)
            ti = ti + (pr * wi + pi_ * wr)
        # the twiddle's angle step rounded to f32, its product with p in f32
        ang = p * round_f32(sign * 2.0 * math.pi * j / n_cur)
        tr, ti = cmul(tr, ti, torch.cos(ang), torch.sin(ang))
        out_r[:, :, j, :] = tr
        out_i[:, :, j, :] = ti
    return out_r.reshape(rows, n), out_i.reshape(rows, n)


def pcr_step(a, b, c, d, stride: int):
    """One full-width cyclic-reduction level at ``stride``: every equation
    eliminates its +-stride neighbours (identity fill b = 1, a = c = d = 0
    keeps the pivots finite)."""
    bm = shift_lanes(b, stride, 1.0)
    bp = shift_lanes(b, -stride, 1.0)
    am, ap = shift_lanes(a, stride, 0.0), shift_lanes(a, -stride, 0.0)
    cm, cp = shift_lanes(c, stride, 0.0), shift_lanes(c, -stride, 0.0)
    dm, dp = shift_lanes(d, stride, 0.0), shift_lanes(d, -stride, 0.0)
    alpha = -a / bm
    gamma = -c / bp
    return (alpha * am,
            b + alpha * cm + gamma * ap,
            gamma * cp,
            d + alpha * dm + gamma * dp)


def rglru_gate(aa: torch.Tensor, uu: torch.Tensor) -> torch.Tensor:
    """RG-LRU input gate b = sqrt(max(1 - a^2, 0)) * u, in-tile.

    The square root is taken in float64 and rounded once, which is the
    correctly rounded square root of the input type (the kernel's
    ``__fsqrt_rn``).  PyTorch's float32 ``sqrt`` on the CPU is not: it is
    off by one ulp on some inputs, and by far more on its first call in a
    process, for one thread's share of the tensor.
    """
    r = torch.clamp_min(1.0 - aa * aa, 0.0)
    return torch.sqrt(r.double()).to(r.dtype) * uu


def carry_init(rows: int, device) -> torch.Tensor:
    """The f32 row carry at the first column tile: zero."""
    return torch.zeros(rows, 1, dtype=torch.float32, device=device)


def carry_fold_add(x: torch.Tensor, carry: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the running prefix into this tile; return it and the new carry."""
    x = x + carry
    return x, x[:, -1:]


def carry_fold_linrec(aa: torch.Tensor, bb: torch.Tensor,
                      carry: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h = b + a * carry for the tile; return it and the tile's exit state."""
    h = bb + aa * carry
    return h, h[:, -1:]
