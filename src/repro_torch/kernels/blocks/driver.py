"""Staged-execution driver: runs a StagePlan's launch list.

The PyTorch counterpart of ``repro.kernels.blocks.driver`` for the prefix
sum:

  * ``multipass_scan_add`` — the paper's §IV-C three-launch block scan
    (chunk scan, carry scan over the chunk sums, entry broadcast), with
    memory roundtrips between launches instead of a serialized carry
    chain;
  * ``apply_add`` — launch 3's kernel wrapper: the hand-written CUDA
    kernel (``csrc/scan.cu`` ``repro_apply_add``) for a CUDA tensor, its
    plain version ``apply_add_plain`` for a CPU tensor.

Every launch is announced to ``record_launch`` with the plan's ``Launch``
record; ``capture_launches`` lets the conformance tests assert that what
runs is exactly what the plan promised — on the card and on the CPU.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, List

import torch
import torch.nn.functional as F

from repro_torch.kernels.blocks.plan import Launch, StagePlan
from repro_torch.tuning.dispatch import kernel_path

_TRACE = threading.local()

# output dtype codes of the C interface
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


@contextlib.contextmanager
def capture_launches():
    """Collect every Launch executed in this thread under the context."""
    captured: List[Launch] = []
    prev = getattr(_TRACE, "sink", None)
    _TRACE.sink = captured
    try:
        yield captured
    finally:
        _TRACE.sink = prev


def record_launch(launch: Launch) -> None:
    sink = getattr(_TRACE, "sink", None)
    if sink is not None:
        sink.append(launch)


def launch(kernel_fn: Callable, record: Launch, *args, **kwargs):
    """Record ``record`` and invoke the kernel wrapper."""
    record_launch(record)
    return kernel_fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# Multi-pass block scan (three launches)
# ---------------------------------------------------------------------------

def apply_add_plain(y: torch.Tensor, entry: torch.Tensor, *, rows: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``y + entry`` in f32, each row's entry broadcast along the row."""
    _check_apply(y, entry, rows, out_dtype)
    return (y + entry).to(out_dtype)


def _check_apply(y: torch.Tensor, entry: torch.Tensor, rows: int,
                 out_dtype: torch.dtype) -> None:
    if y.dim() != 2 or y.dtype != torch.float32:
        raise ValueError(f"apply_add takes (rows, L) float32, got "
                         f"{tuple(y.shape)} {y.dtype}")
    if entry.shape != (y.shape[0], 1) or entry.dtype != torch.float32:
        raise ValueError(f"apply_add takes a ({y.shape[0]}, 1) float32 "
                         f"entry, got {tuple(entry.shape)} {entry.dtype}")
    if rows < 1 or y.shape[0] % rows:
        raise ValueError(f"rows={rows} must divide {y.shape[0]} rows")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"apply_add writes float32 or bfloat16, not "
                        f"{out_dtype}")


def apply_add(y: torch.Tensor, entry: torch.Tensor, *, rows: int,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Multipass launch 3: ``y + entry`` per row, written as ``out_dtype``."""
    if not kernel_path(y):
        return apply_add_plain(y, entry, rows=rows, out_dtype=out_dtype)
    from repro_torch.kernels.build import check, load_library

    _check_apply(y, entry, rows, out_dtype)
    y, entry = y.contiguous(), entry.contiguous()
    if entry.device != y.device:
        raise ValueError("apply_add: y and entry lie on different devices")
    lib = load_library()
    out = torch.empty(y.shape, dtype=out_dtype, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        code = lib.repro_apply_add(y.data_ptr(), entry.data_ptr(),
                                   out.data_ptr(), _OUT_CODES[out_dtype],
                                   y.shape[0], y.shape[1], rows, stream)
    check(code, "apply_add launch")
    apply_add.launches += 1
    return out


# launches of the CUDA kernel (plain-version calls are not counted)
apply_add.launches = 0


def multipass_scan_add(x: torch.Tensor, plan: StagePlan, *,
                       unroll: int = 1) -> torch.Tensor:
    """Prefix sum over (batch, n) as three launches: per-chunk scans,
    exclusive scan over chunk sums, entry broadcast."""
    from repro_torch.kernels.scan.kernel import scan_add
    l1, l2, l3 = plan.launches
    batch, n = x.shape
    p, length = plan.seq_tiles, plan.tile_n
    # inter-launch carries round-trip through device memory; sub-f32 dtypes
    # compute the whole pipeline in f32 and quantize ONCE at the output
    # (launch 3 writes the input dtype), matching the fused path's f32 carry
    xc = x.reshape(batch * p, length)
    if x.dtype != torch.float32:
        xc = xc.to(torch.float32)
    record_launch(l1)
    y_local = scan_add(xc, rows_per_program=l1.block_shape[0],
                       tile_n=length, stages=l1.stages, unroll=unroll)
    sums = y_local[:, -1].reshape(batch, p).contiguous()
    record_launch(l2)
    # the carry scan's tile is the CHUNK COUNT p, not tile_n: clamp the
    # workload-tuned unroll to the l2 launch record's own tile
    csums = scan_add(sums, rows_per_program=l2.block_shape[0], tile_n=p,
                     stages=l2.stages,
                     unroll=max(1, min(unroll, l2.block_shape[1])))
    entry = F.pad(csums[:, :-1], (1, 0)).reshape(batch * p, 1)
    record_launch(l3)
    y = apply_add(y_local, entry, rows=l3.block_shape[0], out_dtype=x.dtype)
    return y.reshape(batch, n)
