"""The scan kernels' wrappers: batched radix-r prefix sum (add monoid)
and linear recurrence (the (a, b) pair monoid).

  * ``scan_add`` replaces ``repro.kernels.scan.kernel.scan_add_pallas``
    with two kernels of ``csrc/scan.cu``, chosen by the plan alone
    (:func:`scan_route`): ``repro_scan_add_warp`` (route "warp": warp
    shuffles and registers, every config of the h100 scan space) and
    ``repro_scan_add`` (route "block": the earlier design, for the tiles and
    stage sequences the warp kernel does not take);
  * ``scan_linrec`` replaces ``scan_linrec_pallas`` and
    ``scan_linrec_prod`` replaces ``scan_linrec_prod_pallas``, both with
    two kernels of ``csrc/linrec.cu`` routed by the plan alone
    (:func:`linrec_route`): ``repro_scan_linrec_warp`` (route "warp": the
    warp scan kernel's design with the (a, b) pair in place of one value)
    and ``repro_scan_linrec`` (route "block": the earlier design).

On a CUDA tensor each launches its hand-written Hopper kernel; on a CPU
tensor it runs its plain version (``*_plain``), the same function in
plain PyTorch: the plan's stage sequence of ``primitives`` levels on each
column tile, then the f32 row carry.  Any other device raises; nothing
falls back.

Layout: problems are rows of a (batch, n) tensor.  Knobs, all consumed:
``rows_per_program`` (rows per thread block), ``tile_n`` (columns per
staged tile; the kernel loops over the n / tile_n tiles with the carry),
``stages`` (the plan's fan-in sequence) and, for the prefix sum,
``unroll`` (the fold order; on the block route also the least elements
per thread).  linrec's fold order is fixed by its algebra: it takes no
``unroll``.  A carrying
tile longer than the kernels' staging runs in pieces (``staged_piece``).

Bound on the card: memory bandwidth — one read of each input, one write
of each output.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import telemetry
from repro_torch.kernels.blocks import primitives as prim
from repro_torch.kernels.blocks.plan import stage_strides
from repro_torch.tuning.dispatch import kernel_path, no_backward

# dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory one thread block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
# the kernel's largest tile: 1024 threads x 32 elements each
MAX_TILE_ELEMS = 32768
# the warp kernels (route "warp"): power-of-two tiles of WARP_MIN_TILE
# (the linrec kernel: WARP_LINREC_MIN_TILE) to MAX_TILE_ELEMS columns,
# fan-ins 2, 4 and 8; the (fan-in, stride) pairs of
# its shuffle stages (stride < 32), which are those stage_radices gives
# power-of-two tiles at radix 2, 4 and 8; a tile above WARP_ROW_COLS
# spreads a row over warps, whose 64-column halo covers a shuffle reach
# (sum of (fan-in - 1) * stride) of WARP_HALO_REACH
WARP_MIN_TILE = 128
WARP_LINREC_MIN_TILE = 2
# the warp chunk kernel (scan_linrec_prod): tiles of WARP_MIN_TILE to
# WARP_PROD_MAX_TILE columns, the ones the admitted h100 plans reach
WARP_PROD_MAX_TILE = 16384
WARP_ROW_COLS = 1024
WARP_HALO_REACH = 63
WARP_SHUFFLE_STAGES = frozenset({(2, 1), (2, 2), (2, 4), (2, 8), (2, 16),
                                 (4, 1), (4, 4), (4, 8), (4, 16),
                                 (8, 1), (8, 8)})
# the scan kernels' routes, each with its own launch count
ROUTES = ("warp", "block")


def staged_piece(rows: int, tile_n: int, stages: Tuple[int, ...]
                 ) -> Tuple[int, Tuple[int, ...]]:
    """The (tile, stages) a carrying scan kernel runs a (rows x tile_n)
    tile with.  A tile within the kernel's MAX_TILE_ELEMS-element staging
    runs as planned.  A longer one (the multipass carry scan's chunk count
    times its rows can be) is walked in pieces: the longest leading run of
    stages whose product p keeps rows * p within the staging.  After those
    stages each element holds its aligned piece's prefix up to itself, so
    the column loop carries the row prefix from piece to piece as it does
    from tile to tile; the sum is the same, rounded in another order.  The
    CUDA launches pass the piece and its stages to the kernels; raises
    when even the first stage does not fit."""
    if rows * tile_n <= MAX_TILE_ELEMS:
        return tile_n, stages
    piece, count = 1, 0
    while count < len(stages) \
            and rows * piece * stages[count] <= MAX_TILE_ELEMS:
        piece *= stages[count]
        count += 1
    if count == 0:
        raise ValueError(f"a {rows} x {tile_n} tile: {rows} rows of its "
                         f"first stage ({stages[0] if stages else 1}) "
                         f"exceed the kernel's {MAX_TILE_ELEMS}-element "
                         f"staging")
    return piece, stages[:count]


def scan_route(rows: int, tile_n: int, stages: Sequence[int],
               min_tile: int = WARP_MIN_TILE) -> str:
    """The prefix-sum kernel a (rows x tile_n) tile with these stages runs
    on, by the plan alone: "warp" where the warp kernel takes the (staged)
    tile — a power of two from ``min_tile`` columns, fan-ins 2, 4 and 8,
    shuffle stages it specialises, the halo's reach where a row spans
    warps — else "block"."""
    piece, stages = staged_piece(rows, tile_n, tuple(int(r) for r in stages))
    if piece < min_tile or piece & (piece - 1) \
            or rows * piece > MAX_TILE_ELEMS:
        return "block"
    stride, reach = 1, 0
    for fan_in in stages:
        if fan_in not in (2, 4, 8):
            return "block"
        if stride < 32:
            if (fan_in, stride) not in WARP_SHUFFLE_STAGES:
                return "block"
            reach += (fan_in - 1) * stride
        stride *= fan_in
    if piece > WARP_ROW_COLS and reach > WARP_HALO_REACH:
        return "block"
    return "warp"


def linrec_route(rows: int, tile_n: int, stages: Sequence[int],
                 products: bool = False) -> str:
    """The linrec kernel a tile runs on: the prefix sum's rule, except
    that the warp linrec kernel (``scan_linrec``) also takes tiles from
    WARP_LINREC_MIN_TILE columns (several rows a warp up to 32), and the
    warp chunk kernel (``products``: ``scan_linrec_prod``) only tiles of
    WARP_MIN_TILE to WARP_PROD_MAX_TILE columns."""
    if products and tile_n > WARP_PROD_MAX_TILE:
        return "block"
    return scan_route(rows, tile_n, stages, min_tile=WARP_MIN_TILE
                      if products else WARP_LINREC_MIN_TILE)


def _check_args(x: torch.Tensor, rows: int, tile_n: int,
                stages: Tuple[int, ...], unroll: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"scan_add takes (batch, n) rows, got {tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"scan_add takes float32 or bfloat16, got {x.dtype}")
    batch, n = x.shape
    if rows < 1 or batch % rows:
        raise ValueError(f"rows_per_program={rows} must divide batch={batch}")
    if tile_n < 1 or n % tile_n:
        raise ValueError(f"tile_n={tile_n} must divide n={n}")
    if math.prod(stages) != tile_n:
        raise ValueError(f"stages {stages} multiply to {math.prod(stages)}, "
                         f"not tile_n={tile_n}")
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")


def scan_add_plain(x: torch.Tensor, *, rows_per_program: int, tile_n: int,
                   stages: Sequence[int], unroll: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch: per column tile, the stage
    loop in f32, then the f32 carry; rows are independent, so one pass
    over all of them computes what every row block computes."""
    stages = tuple(int(r) for r in stages)
    _check_args(x, rows_per_program, tile_n, stages, unroll)
    tile_n, stages = staged_piece(rows_per_program, tile_n, stages)
    batch, n = x.shape
    out = torch.empty_like(x)
    carry = prim.carry_init(batch, x.device)
    for j in range(n // tile_n):
        t = x[:, j * tile_n:(j + 1) * tile_n].to(torch.float32)
        for fan_in, stride in zip(stages, stage_strides(stages)):
            t = prim.shift_fold(t, fan_in, stride, fill=0.0, unroll=unroll)
        t, carry = prim.carry_fold_add(t, carry)
        out[:, j * tile_n:(j + 1) * tile_n] = t.to(x.dtype)
    return out


def _launch(x: torch.Tensor, rows: int, tile_n: int,
            stages: Tuple[int, ...], unroll: int,
            route: Optional[str] = None) -> torch.Tensor:
    """Launch one kernel: ``route`` "warp" or "block"; by default the one
    :func:`scan_route` picks.  Returns the output; counts nothing."""
    from repro_torch.kernels.build import check, load_library

    _check_args(x, rows, tile_n, stages, unroll)
    if not x.is_cuda:
        raise ValueError(f"the CUDA scan kernel needs a CUDA tensor, got "
                         f"one on {x.device}")
    if not x.is_contiguous():
        raise ValueError("scan_add takes a contiguous tensor")
    route = route or scan_route(rows, tile_n, stages)
    if route not in ROUTES:
        raise ValueError(f"unknown scan_add route {route!r}")
    # the kernels run a tile longer than their staging as staged pieces
    piece, stages = staged_piece(rows, tile_n, stages)
    if route == "block" and 4 * (rows * piece + rows) > SMEM_LIMIT:
        raise ValueError(f"a {rows} x {piece} tile exceeds a block's "
                         f"shared memory")
    lib = load_library()
    entry = lib.repro_scan_add_warp if route == "warp" \
        else lib.repro_scan_add
    y = torch.empty_like(x)
    batch, n = x.shape
    fan_in = (ctypes.c_int * max(len(stages), 1))(*stages)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = entry(x.data_ptr(), y.data_ptr(), DTYPE_CODES[x.dtype], batch,
                     n, rows, piece, fan_in, len(stages), unroll, stream)
    check(code, f"scan_add launch ({route})")
    return no_backward("scan_add", y, x)


def scan_add_block(x: torch.Tensor, *, rows_per_program: int, tile_n: int,
                   stages: Sequence[int], unroll: int = 1) -> torch.Tensor:
    """The block kernel (the earlier design) on a CUDA tensor whatever the
    route: its record, timed beside the warp kernel.  No entry point calls
    it, and it counts no launch."""
    return _launch(x.contiguous(), rows_per_program, tile_n,
                   tuple(int(r) for r in stages), unroll, route="block")


@telemetry.spanned("repro.launch.scan_add")
def scan_add(x: torch.Tensor, *, rows_per_program: int, tile_n: int,
             stages: Sequence[int], unroll: int = 1) -> torch.Tensor:
    """Inclusive prefix sum over the last axis of (batch, n)."""
    stages = tuple(int(r) for r in stages)
    if not kernel_path(x):
        return scan_add_plain(x, rows_per_program=rows_per_program,
                              tile_n=tile_n, stages=stages, unroll=unroll)
    _check_args(x, rows_per_program, tile_n, stages, unroll)
    route = scan_route(rows_per_program, tile_n, stages)
    y = _launch(x.contiguous(), rows_per_program, tile_n, stages, unroll,
                route)
    count_launch(scan_add, route)
    return y


def count_launch(fn, route: str) -> None:
    """One more CUDA launch of wrapper ``fn``, on ``route``."""
    fn.launches += 1
    setattr(fn, f"launches_{route}", getattr(fn, f"launches_{route}") + 1)


# launches of the CUDA kernels (plain-version calls are not counted): all,
# and by route
scan_add.launches = 0
scan_add.launches_warp = 0
scan_add.launches_block = 0


# ---------------------------------------------------------------------------
# Linear recurrence h_t = a_t h_{t-1} + b_t
# ---------------------------------------------------------------------------

def _check_linrec(a: torch.Tensor, b: torch.Tensor, rows: int, tile_n: int,
                  stages: Tuple[int, ...]) -> None:
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"scan_linrec takes two (batch, n) tensors of one "
                         f"shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"scan_linrec takes float32 or bfloat16 pairs of one "
                        f"type, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError("scan_linrec: a and b lie on different devices")
    batch, n = a.shape
    if rows < 1 or batch % rows:
        raise ValueError(f"rows_per_program={rows} must divide batch={batch}")
    if tile_n < 1 or n % tile_n:
        raise ValueError(f"tile_n={tile_n} must divide n={n}")
    if math.prod(stages) != tile_n:
        raise ValueError(f"stages {stages} multiply to {math.prod(stages)}, "
                         f"not tile_n={tile_n}")


def _linrec_tiles(a: torch.Tensor, b: torch.Tensor, tile_n: int,
                  stages: Tuple[int, ...], gate: bool, carry: bool):
    """Per column tile: the f32 stage loop, then (with ``carry``) the f32
    row carry.  Yields (column slice, h, prefix products) per tile."""
    batch, n = a.shape
    state = prim.carry_init(batch, a.device)
    for j in range(n // tile_n):
        cols = slice(j * tile_n, (j + 1) * tile_n)
        aa = a[:, cols].to(torch.float32)
        bb = b[:, cols].to(torch.float32)
        if gate:
            bb = prim.rglru_gate(aa, bb)
        for fan_in, stride in zip(stages, stage_strides(stages)):
            aa, bb = prim.linrec_level(aa, bb, fan_in, stride)
        h = bb
        if carry:
            h, state = prim.carry_fold_linrec(aa, bb, state)
        yield cols, h, aa


def scan_linrec_plain(a: torch.Tensor, b: torch.Tensor, *,
                      rows_per_program: int, tile_n: int,
                      stages: Sequence[int], gate: bool = False
                      ) -> torch.Tensor:
    """The linrec kernel's function in plain PyTorch (rows are independent,
    so one pass over all of them computes what every row block does)."""
    stages = tuple(int(r) for r in stages)
    _check_linrec(a, b, rows_per_program, tile_n, stages)
    tile_n, stages = staged_piece(rows_per_program, tile_n, stages)
    h = torch.empty_like(a)
    for cols, t, _ in _linrec_tiles(a, b, tile_n, stages, gate, carry=True):
        h[:, cols] = t.to(a.dtype)
    return h


def scan_linrec_prod_plain(a: torch.Tensor, b: torch.Tensor, *,
                           rows_per_program: int, stages: Sequence[int],
                           gate: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk kernel's function in plain PyTorch: one tile per row, no
    carry; returns h and the prefix products of a."""
    stages = tuple(int(r) for r in stages)
    _check_linrec(a, b, rows_per_program, a.shape[-1], stages)
    (_, h, p), = _linrec_tiles(a, b, a.shape[-1], stages, gate, carry=False)
    return h.to(a.dtype), p.to(a.dtype)


def _launch_linrec(a: torch.Tensor, b: torch.Tensor, rows: int, tile_n: int,
                   stages: Tuple[int, ...], gate: bool, products: bool,
                   route: Optional[str] = None):
    """Launch one linrec kernel: ``route`` "warp" or "block"; by default
    the one :func:`linrec_route` picks.  Returns (h, products or None);
    counts nothing."""
    from repro_torch.kernels.build import check, load_library

    _check_linrec(a, b, rows, tile_n, stages)
    if not a.is_cuda:
        raise ValueError(f"the CUDA linrec kernel needs CUDA tensors, got "
                         f"ones on {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("scan_linrec takes contiguous tensors")
    if products and rows * tile_n > MAX_TILE_ELEMS:
        # the chunk kernel has no carry to walk pieces with
        raise ValueError(f"a {rows} x {tile_n} tile exceeds the chunk "
                         f"kernel's {MAX_TILE_ELEMS} elements per block")
    route = route or linrec_route(rows, tile_n, stages, products)
    if route not in ROUTES:
        raise ValueError(f"unknown scan_linrec route {route!r}")
    # the carrying kernels run a tile longer than their staging as pieces
    piece, stages = (tile_n, stages) if products \
        else staged_piece(rows, tile_n, stages)
    lib = load_library()
    entry = lib.repro_scan_linrec_warp if route == "warp" \
        else lib.repro_scan_linrec
    batch, n = a.shape
    h = torch.empty_like(a)
    p = torch.empty_like(a) if products else None
    floats = lib.repro_linrec_scratch(batch, rows, piece,
                                      1 if route == "warp" else 0)
    if floats < 0:
        raise ValueError(f"the {route} linrec kernel does not take a "
                         f"{rows} x {piece} tile")
    scratch = torch.empty(floats, dtype=torch.float32, device=a.device) \
        if floats else None
    fan_in = (ctypes.c_int * max(len(stages), 1))(*stages)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = entry(
            a.data_ptr(), b.data_ptr(), h.data_ptr(),
            p.data_ptr() if products else None, DTYPE_CODES[a.dtype], batch,
            n, rows, piece, fan_in, len(stages), int(gate),
            0 if products else 1,
            scratch.data_ptr() if scratch is not None else None, stream)
    check(code, f"scan_linrec launch ({route})")
    return no_backward("scan_linrec_prod" if products else "scan_linrec",
                       (h, p), a, b)


@telemetry.spanned("repro.launch.scan_linrec")
def scan_linrec(a: torch.Tensor, b: torch.Tensor, *, rows_per_program: int,
                tile_n: int, stages: Sequence[int], gate: bool = False
                ) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along the last axis of (batch, n) pairs.

    ``gate=True`` is the fused RG-LRU chain link: ``b`` carries the raw
    input u and the kernel applies the gate in-tile before the stage loop.
    """
    stages = tuple(int(r) for r in stages)
    if not kernel_path(a):
        return scan_linrec_plain(a, b, rows_per_program=rows_per_program,
                                 tile_n=tile_n, stages=stages, gate=gate)
    _check_linrec(a, b, rows_per_program, tile_n, stages)
    route = linrec_route(rows_per_program, tile_n, stages)
    h, _ = _launch_linrec(a.contiguous(), b.contiguous(), rows_per_program,
                          tile_n, stages, gate, products=False, route=route)
    count_launch(scan_linrec, route)
    return h


@telemetry.spanned("repro.launch.scan_linrec_prod")
def scan_linrec_prod(a: torch.Tensor, b: torch.Tensor, *,
                     rows_per_program: int, stages: Sequence[int],
                     gate: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-tile linrec (tile_n = n) returning (h, prefix products of a):
    the multipass driver's chunk kernel, whose products are each chunk's
    transfer operator."""
    stages = tuple(int(r) for r in stages)
    if not kernel_path(a):
        return scan_linrec_prod_plain(a, b, rows_per_program=rows_per_program,
                                      stages=stages, gate=gate)
    _check_linrec(a, b, rows_per_program, a.shape[-1], stages)
    route = linrec_route(rows_per_program, a.shape[-1], stages,
                         products=True)
    out = _launch_linrec(a.contiguous(), b.contiguous(), rows_per_program,
                         a.shape[-1], stages, gate, products=True,
                         route=route)
    count_launch(scan_linrec_prod, route)
    return out


# launches of the CUDA kernels (plain-version calls are not counted): all,
# and by route
scan_linrec.launches = 0
scan_linrec.launches_warp = 0
scan_linrec.launches_block = 0
scan_linrec_prod.launches = 0
scan_linrec_prod.launches_warp = 0
scan_linrec_prod.launches_block = 0
