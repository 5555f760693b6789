"""In-kernel building blocks, in plain PyTorch.

The PyTorch counterparts of ``repro.kernels.blocks.primitives`` for the
prefix sum: ``shift_lanes``, the balanced ``_tree_fold``, one radix-r
``shift_fold`` level, and the cross-tile carry chain.  They are the plain
version of the CUDA scan kernel's body (``csrc/scan.cu``): the same stage
sequence, the same neighbour fill, the same fold order for each
``unroll``, so the kernel and its plain version add the same numbers in
the same order.  Stage sequences come from
``repro_torch.kernels.blocks.plan.stage_radices`` — never recompute them
here.
"""
from __future__ import annotations

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


def carry_init(rows: int, device) -> torch.Tensor:
    """The f32 row carry at the first column tile: zero."""
    return torch.zeros(rows, 1, dtype=torch.float32, device=device)


def carry_fold_add(x: torch.Tensor, carry: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold the running prefix into this tile; return it and the new carry."""
    x = x + carry
    return x, x[:, -1:]
