"""The FFT kernel's wrapper: batched complex DFT by self-sorting mixed-radix
Stockham stages.

``fft_stockham`` replaces ``repro.kernels.fft.kernel.fft_pallas``.  On a
CUDA tensor it launches one of two hand-written Hopper kernels of
``csrc/fft.cu``, chosen by the plan alone (:func:`fft_route`):
``repro_fft_pow2`` (route "pow2": power-of-two rows of 16 to 8192 points,
fan-ins 2, 4, 8 and 16 — every config of the h100 fft space) or ``repro_fft`` (route "generic": the earlier design,
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

``fft_pass`` is one pass of the four-step driver (``blocks.driver
.four_step_fft``): the same transform on problems laid out at strides in a
(batch, total) array (:class:`PassLayout`), read once and written once,
with the four-step's transpose as the addressing of its loads and stores
and its twiddle multiply at the store.  On a CUDA tensor it launches
``repro_fft_pass`` (``csrc/fft.cu``: the pow2 kernel's stage groups, the
first loading a program's adjacent problems straight from device memory,
the last storing them there with the twiddle), counted in
``fft_pass.launches``; on a CPU tensor ``fft_pass_plain`` (gather,
``fft_plain``, twiddle, scatter in torch).  A pass the kernel cannot
address (a row off the pow2 route, or a stride that is no power of two, as
at N = 3 x 4096) runs the Stockham kernel between the same torch gather and
scatter on the card, counted as ``fft_stockham``'s launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

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
# the pass kernel's program: adjacent problems, all resident at once, for
# PASS_POINTS points (256 threads), or at least PASS_MIN_PROBLEMS (runs of
# 32 bytes, whole sectors) up to PASS_MAX_POINTS (512 threads)
PASS_POINTS = 4096
PASS_MAX_POINTS = 8192
PASS_MIN_PROBLEMS = 4


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


# ---------------------------------------------------------------------------
# One pass of the four-step FFT
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PassLayout:
    """Where a four-step pass reads and writes in a (batch, total) array.

    Each batch item holds total / n problems c of n points: point t of
    problem c lies at ``(c // lo) * in_hs + c % lo + t * in_ps`` and its
    output k goes to ``(c // lo) * out_hs + c % lo + k * out_ps``.  Where
    ``tw_n`` > 0, output k is multiplied by exp(-+2 pi i e / tw_n) with
    e = ((c % lo) // tw_div) * (k * tw_kmul + c // lo): the angle from the
    integer e in f32, times the f32 of -+2 pi, over tw_n, as the JAX
    package's four-step twiddle."""
    total: int
    n: int
    lo: int
    in_ps: int
    in_hs: int
    out_ps: int
    out_hs: int
    tw_n: int = 0
    tw_div: int = 1
    tw_kmul: int = 1

    @property
    def problems(self) -> int:
        """Problems of one batch item."""
        return self.total // self.n

    def as_array(self) -> Tuple[int, ...]:
        """The kernel's ``layout`` argument."""
        return (self.total, self.lo, self.in_ps, self.in_hs, self.out_ps,
                self.out_hs, self.tw_n, self.tw_div, self.tw_kmul)


def _pow2(v: int) -> bool:
    return v >= 1 and not v & (v - 1)


def pass_skew(problems: int) -> int:
    """Slots the pass kernel leaves after each resident row, so that lanes
    across the rows fall on distinct banks."""
    return 1 if problems >= 16 else 16 // problems


def pass_problems(layout: PassLayout, stages: Sequence[int]) -> int:
    """Adjacent problems a block of the pass kernel holds at once (its
    program): PASS_POINTS points' worth, or PASS_MIN_PROBLEMS within
    PASS_MAX_POINTS, at most the problems of a batch item, halved until the
    rows and the tables fit a block's shared memory.  0 where the kernel
    cannot address the pass: a row off the pow2 route, or a stride that is
    no power of two.  A pass it can address always fits (one row and its
    tables fit, as the route requires); a batch item of 2^31 points or more
    raises."""
    n = layout.n
    stages = tuple(int(r) for r in stages)
    shifts = (layout.lo, layout.in_ps, layout.in_hs, layout.out_ps,
              layout.out_hs, layout.tw_div, layout.tw_kmul,
              layout.tw_n or 1)
    if fft_route(n, stages) != "pow2" or layout.total % n \
            or not all(map(_pow2, shifts)):
        return 0
    if layout.total >= 1 << 31:
        raise ValueError(f"the FFT pass kernel addresses a batch item in 32 "
                         f"bits; {layout.total} points do not fit")
    q = layout.problems
    c = min(max(PASS_POINTS // n, min(PASS_MIN_PROBLEMS,
                                      PASS_MAX_POINTS // n), 1), q & -q)
    table = pow2_table_points(n, stages)
    while c >= 1:
        points = c * n
        if 8 * (table + points + points // 16 + c * pass_skew(c)) \
                <= SMEM_LIMIT:
            return c
        c //= 2
    raise ValueError(f"an n={n} pass with stages {stages} does not fit the "
                     f"pass kernel's shared memory ({SMEM_LIMIT} bytes)")


def pass_twiddle(layout: PassLayout, inverse: bool,
                 device: torch.device) -> torch.Tensor:
    """The pass's twiddles over (problems, n), complex64."""
    c = torch.arange(layout.problems, device=device).reshape(-1, 1)
    k = torch.arange(layout.n, device=device).reshape(1, -1)
    e = (c % layout.lo // layout.tw_div) \
        * (k * layout.tw_kmul + c // layout.lo)
    sign = 1.0 if inverse else -1.0
    ang = e.to(torch.float32) * prim.round_f32(sign * 2.0 * math.pi) \
        / layout.tw_n
    return torch.polar(torch.ones_like(ang), ang)


def _pass_composed(x: torch.Tensor, layout: PassLayout, inverse: bool,
                   fft_rows: Callable[[torch.Tensor], torch.Tensor]
                   ) -> torch.Tensor:
    """The pass as torch ops around ``fft_rows``: gather each problem into a
    row, transform, twiddle, scatter."""
    if x.dim() != 2 or x.shape[1] != layout.total:
        raise ValueError(f"fft_pass takes (batch, {layout.total}) rows, got "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    batch, n, lo = x.shape[0], layout.n, layout.lo
    view = (batch, layout.problems // lo, lo, n)
    rows = x.as_strided(view, (layout.total, layout.in_hs, 1, layout.in_ps),
                        x.storage_offset()).reshape(-1, n)
    y = fft_rows(rows).reshape(batch, layout.problems, n)
    if layout.tw_n:
        y = y * pass_twiddle(layout, inverse, x.device)
    out = torch.empty(x.shape, dtype=y.dtype, device=x.device)
    out.as_strided(view, (layout.total, layout.out_hs, 1, layout.out_ps)) \
        .copy_(y.reshape(view))
    return out


def fft_pass_plain(x: torch.Tensor, layout: PassLayout, *,
                   stages: Sequence[int], inverse: bool = False,
                   unroll: int = 1) -> torch.Tensor:
    """The pass in plain PyTorch: gather, ``fft_plain``, twiddle, scatter."""
    return _pass_composed(x, layout, inverse, lambda rows: fft_plain(
        rows, rows_per_program=1, stages=stages, inverse=inverse,
        unroll=unroll))


def _launch_pass(x: torch.Tensor, layout: PassLayout,
                 stages: Sequence[int], inverse: bool, unroll: int,
                 problems: int) -> torch.Tensor:
    """Launch the pass kernel with ``problems`` adjacent problems a
    program; counts nothing."""
    from repro_torch.kernels.build import check, load_library

    if not x.is_cuda:
        raise ValueError(f"the CUDA FFT pass kernel needs a CUDA tensor, got "
                         f"one on {x.device}")
    if x.dim() != 2 or x.shape[1] != layout.total:
        raise ValueError(f"fft_pass takes (batch, {layout.total}) rows, got "
                         f"{tuple(x.shape)}")
    x = x.to(torch.complex64).contiguous()
    stages = tuple(int(r) for r in stages)
    lib = load_library()
    y = torch.empty_like(x)
    radix = (ctypes.c_int * max(len(stages), 1))(*stages)
    lay = (ctypes.c_longlong * 9)(*layout.as_array())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.repro_fft_pass(x.data_ptr(), y.data_ptr(), x.shape[0],
                                  layout.n, problems, radix, len(stages),
                                  unroll, int(inverse), lay, stream)
    check(code, "fft pass launch")
    return no_backward("fft_pass", y, x)


@telemetry.spanned("repro.launch.fft_pass")
def fft_pass(x: torch.Tensor, layout: PassLayout, *, stages: Sequence[int],
             inverse: bool = False, unroll: int = 1) -> torch.Tensor:
    """One four-step pass over (batch, layout.total) (see
    :class:`PassLayout`); returns complex64.  The kernel's program is
    :func:`pass_problems`'s; a pass it cannot address runs
    ``fft_stockham`` between torch's gather and scatter (rows change no
    result, so one row a program)."""
    stages = tuple(int(r) for r in stages)
    if not kernel_path(x):
        return fft_pass_plain(x, layout, stages=stages, inverse=inverse,
                              unroll=unroll)
    problems = pass_problems(layout, stages)
    if not problems:
        return _pass_composed(x, layout, inverse, lambda rows: fft_stockham(
            rows, rows_per_program=1, stages=stages, inverse=inverse,
            unroll=unroll))
    y = _launch_pass(x, layout, stages, inverse, unroll, problems)
    fft_pass.launches += 1
    return y


# launches of the CUDA pass kernel (the plain version and the composed
# passes are not counted: those count as fft_stockham's)
fft_pass.launches = 0
