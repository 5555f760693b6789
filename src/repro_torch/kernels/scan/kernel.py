"""The scan kernel's wrapper: batched radix-r prefix sum (add monoid).

``scan_add`` replaces ``repro.kernels.scan.kernel.scan_add_pallas``.  On a
CUDA tensor it launches the hand-written Hopper kernel of
``csrc/scan.cu`` (``repro_scan_add``); on a CPU tensor it runs
``scan_add_plain``, the same function in plain PyTorch: the plan's stage
sequence of ``primitives.shift_fold`` levels on each column tile, then the
f32 row carry.  Any other device raises; nothing falls back.

Layout: problems are rows of a (batch, n) tensor.  Knobs, all consumed:
``rows_per_program`` (rows per thread block), ``tile_n`` (columns per
staged tile; the kernel loops over the n / tile_n tiles with the carry),
``stages`` (the plan's fan-in sequence) and ``unroll`` (fold order, and
the least elements per thread).

Bound on the card: memory bandwidth — one read of x, one write of y.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from repro_torch.kernels.blocks import primitives as prim
from repro_torch.kernels.blocks.plan import stage_strides
from repro_torch.tuning.dispatch import kernel_path

# dtype codes of the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory one thread block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
# the kernel's largest tile: 1024 threads x 32 elements each
MAX_TILE_ELEMS = 32768


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
            stages: Tuple[int, ...], unroll: int) -> torch.Tensor:
    from repro_torch.kernels.build import check, load_library

    _check_args(x, rows, tile_n, stages, unroll)
    if not x.is_cuda:
        raise ValueError(f"the CUDA scan kernel needs a CUDA tensor, got "
                         f"one on {x.device}")
    if not x.is_contiguous():
        raise ValueError("scan_add takes a contiguous tensor")
    if rows * tile_n > MAX_TILE_ELEMS \
            or 4 * (rows * tile_n + rows) > SMEM_LIMIT:
        raise ValueError(f"a {rows} x {tile_n} tile exceeds the kernel's "
                         f"{MAX_TILE_ELEMS}-element f32 staging tile")
    lib = load_library()
    y = torch.empty_like(x)
    batch, n = x.shape
    fan_in = (ctypes.c_int * max(len(stages), 1))(*stages)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.repro_scan_add(x.data_ptr(), y.data_ptr(),
                                  DTYPE_CODES[x.dtype], batch, n, rows,
                                  tile_n, fan_in, len(stages), unroll, stream)
    check(code, "scan_add launch")
    scan_add.launches += 1
    return y


def scan_add(x: torch.Tensor, *, rows_per_program: int, tile_n: int,
             stages: Sequence[int], unroll: int = 1) -> torch.Tensor:
    """Inclusive prefix sum over the last axis of (batch, n)."""
    stages = tuple(int(r) for r in stages)
    if kernel_path(x):
        return _launch(x.contiguous(), rows_per_program, tile_n, stages,
                       unroll)
    return scan_add_plain(x, rows_per_program=rows_per_program,
                          tile_n=tile_n, stages=stages, unroll=unroll)


# launches of the CUDA kernel (plain-version calls are not counted)
scan_add.launches = 0
