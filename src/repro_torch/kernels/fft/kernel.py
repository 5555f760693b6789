"""The FFT kernel's wrapper: batched complex DFT by self-sorting mixed-radix
Stockham stages.

``fft_stockham`` replaces ``repro.kernels.fft.kernel.fft_pallas``.  On a
CUDA tensor it launches one of two hand-written Hopper kernels of
``csrc/fft.cu``, chosen by the plan alone (:func:`fft_route`):
``repro_fft_pow2`` (route "pow2": power-of-two rows of 16 to 8192 points,
fan-ins 2, 4, 8 and 16 — every config of the h100 fft space and every
four-step launch) or ``repro_fft`` (route "generic": the earlier design,
for ragged and prime stages and short rows); each route counts its
launches (``fft_stockham.launches_pow2``, ``.launches_generic``), and both
count into ``.launches``.  On a CPU tensor it runs ``fft_plain``, the same
function in plain PyTorch: ``primitives.butterfly`` folded over the stage
sequence on split re/im f32 planes, then the 1/n scale when inverse.  Any
other device raises; nothing falls back.

Layout: each row of a (batch, n) complex tensor is one transform, kept
whole on chip.  The kernel reads and writes the interleaved complex64
buffer (the TPU kernel's split re/im planes were a TPU need: its vector
registers are real); the plain version splits planes, as the TPU kernel
does, and both compute the same function.  Knobs: ``rows_per_program``
(the rows a block holds at once, in groups where they do not fit),
``stages`` (the plan's fan-in sequence) and ``unroll`` (launch geometry
only: 16 points a thread at 1 and 32 above on the pow2 route, the least
butterflies a thread owns per stage on the generic one — the TPU kernel
ignores it, and the JAX package's FFT normalizer drops it from a resolved
config, so the entry points launch with the plan's ``ilp`` of 1).

Bound on the card: memory bandwidth — one complex64 read and one written
per element.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import telemetry
from repro_torch.kernels.blocks import primitives as prim
from repro_torch.tuning.dispatch import kernel_path, no_backward

# shared memory one thread block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
# the pow2 kernel: power-of-two rows of POW2_MIN_N to POW2_MAX_N points,
# these fan-ins; it holds the rows of a program (a pad slot every 16
# points) plus its weight and twiddle tables (sum of rr, and of (rr - 1) m,
# complex64) in shared memory
POW2_MIN_N = 16
POW2_MAX_N = 8192
POW2_RADICES = (2, 4, 8, 16)
# the FFT kernels' routes, each with its own launch count
ROUTES = ("pow2", "generic")


def pow2_table_points(n: int, stages: Sequence[int]) -> int:
    """Complex entries of the pow2 kernel's tables for this plan: each
    stage's rr DFT weights and (rr - 1) m twiddles."""
    points, n_cur = 0, n
    for rr in stages:
        points += rr + (rr - 1) * (n_cur // rr)
        n_cur //= rr
    return points


def fft_route(n: int, stages: Sequence[int]) -> str:
    """The kernel an n-point plan runs on, by the plan alone: "pow2" where
    n is a power of two from POW2_MIN_N to POW2_MAX_N, every fan-in is in
    POW2_RADICES and one row and the tables fit a block's shared memory;
    else "generic"."""
    stages = tuple(int(r) for r in stages)
    if n < POW2_MIN_N or n > POW2_MAX_N or n & (n - 1) \
            or any(r not in POW2_RADICES for r in stages) \
            or math.prod(stages) != n:
        return "generic"
    if 8 * (n + n // 16 + pow2_table_points(n, stages)) > SMEM_LIMIT:
        return "generic"
    return "pow2"


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
            inverse: bool, unroll: int,
            route: Optional[str] = None) -> torch.Tensor:
    """Launch one kernel: ``route`` "pow2" or "generic"; by default the one
    :func:`fft_route` picks.  Returns the output; counts nothing."""
    from repro_torch.kernels.build import check, load_library

    if not x.is_cuda:
        raise ValueError(f"the CUDA FFT kernel needs a CUDA tensor, got one "
                         f"on {x.device}")
    x = x.to(torch.complex64).contiguous()
    _check_args(x, rows, stages, unroll)
    batch, n = x.shape
    route = route or fft_route(n, stages)
    if route not in ROUTES:
        raise ValueError(f"unknown fft_stockham route {route!r}")
    if route == "generic":
        buffers = min(max(len(stages) - 1, 0), 2)     # ping-pong planes
        if buffers * 8 * n + 12 * sum(stages) > SMEM_LIMIT:
            raise ValueError(f"an n={n} row does not fit the kernel's "
                             f"shared-memory staging ({SMEM_LIMIT} bytes)")
    lib = load_library()
    entry = lib.repro_fft_pow2 if route == "pow2" else lib.repro_fft
    y = torch.empty_like(x)
    radix = (ctypes.c_int * max(len(stages), 1))(*stages)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = entry(x.data_ptr(), y.data_ptr(), batch, n, rows, radix,
                     len(stages), unroll, int(inverse), stream)
    check(code, f"fft launch ({route})")
    return no_backward("fft_stockham", y, x)


def fft_generic(x: torch.Tensor, *, rows_per_program: int,
                stages: Sequence[int], inverse: bool = False,
                unroll: int = 1) -> torch.Tensor:
    """The generic kernel (the earlier design) on a CUDA tensor whatever the
    route: its record, timed beside the pow2 kernel.  No entry point calls
    it, and it counts no launch."""
    return _launch(x, rows_per_program, tuple(int(r) for r in stages),
                   inverse, unroll, route="generic")


@telemetry.spanned("repro.launch.fft_stockham")
def fft_stockham(x: torch.Tensor, *, rows_per_program: int,
                 stages: Sequence[int], inverse: bool = False,
                 unroll: int = 1) -> torch.Tensor:
    """Row-wise complex DFT of (batch, n) (inverse: scaled by 1/n);
    returns complex64."""
    stages = tuple(int(r) for r in stages)
    if not kernel_path(x):
        return fft_plain(x, rows_per_program=rows_per_program, stages=stages,
                         inverse=inverse, unroll=unroll)
    route = fft_route(x.shape[-1], stages)
    y = _launch(x, rows_per_program, stages, inverse, unroll, route)
    fft_stockham.launches += 1
    setattr(fft_stockham, f"launches_{route}",
            getattr(fft_stockham, f"launches_{route}") + 1)
    return y


# launches of the CUDA kernels (plain-version calls are not counted): all,
# and by route
fft_stockham.launches = 0
fft_stockham.launches_pow2 = 0
fft_stockham.launches_generic = 0
