"""The FFT kernel's wrapper: batched complex DFT by self-sorting mixed-radix
Stockham stages.

``fft_stockham`` replaces ``repro.kernels.fft.kernel.fft_pallas``.  On a
CUDA tensor it launches the hand-written Hopper kernel of ``csrc/fft.cu``
(``repro_fft``); on a CPU tensor it runs ``fft_plain``, the same function
in plain PyTorch: ``primitives.butterfly`` folded over the stage sequence
on split re/im f32 planes, then the 1/n scale when inverse.  Any other
device raises; nothing falls back.

Layout: each row of a (batch, n) complex tensor is one transform, kept
whole on chip.  The kernel reads and writes the interleaved complex64
buffer (the TPU kernel's split re/im planes were a TPU need: its vector
registers are real); the plain version splits planes, as the TPU kernel
does, and both compute the same function.  Knobs: ``rows_per_program``
(rows per thread block), ``stages`` (the plan's fan-in sequence) and
``unroll`` (the least butterflies a thread owns per stage: launch geometry
only — the TPU kernel ignores it, and the JAX package's FFT normalizer
drops it from a resolved config, so the entry points launch with the
plan's ``ilp`` of 1).

Bound on the card: memory bandwidth — one complex64 read and one written
per element.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from repro_torch.kernels.blocks import primitives as prim
from repro_torch.tuning.dispatch import kernel_path

# shared memory one thread block may use on Hopper (227 KB)
SMEM_LIMIT = 232448


def _check_args(x: torch.Tensor, rows: int, stages: Tuple[int, ...],
                unroll: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"fft_stockham takes (batch, n) rows, got "
                         f"{tuple(x.shape)}")
    if not x.is_complex():
        raise TypeError(f"fft_stockham takes a complex tensor, got {x.dtype}")
    batch, n = x.shape
    if rows < 1 or batch % rows:
        raise ValueError(f"rows_per_program={rows} must divide batch={batch}")
    if math.prod(stages) != n or any(r < 2 for r in stages):
        raise ValueError(f"stages {stages} must be fan-ins >= 2 that "
                         f"multiply to n={n}")
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")


def fft_plain(x: torch.Tensor, *, rows_per_program: int,
              stages: Sequence[int], inverse: bool = False,
              unroll: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in f32 (rows are
    independent, so one pass over all of them computes what every block
    computes); returns complex64."""
    stages = tuple(int(r) for r in stages)
    _check_args(x, rows_per_program, stages, unroll)
    n = x.shape[1]
    sign = 1.0 if inverse else -1.0
    re = x.real.to(torch.float32)
    im = x.imag.to(torch.float32)
    n_cur, s = n, 1
    for rr in stages:
        re, im = prim.butterfly(re, im, n=n, n_cur=n_cur, s=s, rr=rr,
                                sign=sign)
        n_cur, s = n_cur // rr, s * rr
    if inverse:
        scale = prim.round_f32(1.0 / n)
        re, im = re * scale, im * scale
    return torch.complex(re, im)


def _launch(x: torch.Tensor, rows: int, stages: Tuple[int, ...],
            inverse: bool, unroll: int) -> torch.Tensor:
    from repro_torch.kernels.build import check, load_library

    if not x.is_cuda:
        raise ValueError(f"the CUDA FFT kernel needs a CUDA tensor, got one "
                         f"on {x.device}")
    x = x.to(torch.complex64).contiguous()
    _check_args(x, rows, stages, unroll)
    batch, n = x.shape
    buffers = min(max(len(stages) - 1, 0), 2)     # ping-pong planes
    if buffers * 8 * n + 12 * sum(stages) > SMEM_LIMIT:
        raise ValueError(f"an n={n} row does not fit the kernel's "
                         f"shared-memory staging ({SMEM_LIMIT} bytes)")
    lib = load_library()
    y = torch.empty_like(x)
    radix = (ctypes.c_int * max(len(stages), 1))(*stages)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.repro_fft(x.data_ptr(), y.data_ptr(), batch, n, rows,
                             radix, len(stages), unroll, int(inverse), stream)
    check(code, "fft launch")
    fft_stockham.launches += 1
    return y


def fft_stockham(x: torch.Tensor, *, rows_per_program: int,
                 stages: Sequence[int], inverse: bool = False,
                 unroll: int = 1) -> torch.Tensor:
    """Row-wise complex DFT of (batch, n) (inverse: scaled by 1/n);
    returns complex64."""
    stages = tuple(int(r) for r in stages)
    if kernel_path(x):
        return _launch(x, rows_per_program, stages, inverse, unroll)
    return fft_plain(x, rows_per_program=rows_per_program, stages=stages,
                     inverse=inverse, unroll=unroll)


# launches of the CUDA kernel (plain-version calls are not counted)
fft_stockham.launches = 0
