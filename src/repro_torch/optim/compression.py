"""int8 gradient compression with error feedback: the numerics of the wire
format and the compressed all-reduce over a pod axis
(``repro.optim.compression``).  ``torch.round`` rounds half to even, as
``jnp.round`` does."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.tree import tree_map, tree_unzip

Tree = Any


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale f32 scalar, new_err)."""
    g32 = g.to(torch.float32) + err
    scale = torch.max(torch.abs(g32)) / 127.0 + 1e-12
    q = torch.clip(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_err = g32 - q.to(torch.float32) * scale
    return q, scale, new_err


def decompress(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def ef_roundtrip(grads: Tree, err: Tree) -> Tuple[Tree, Tree]:
    """Compress and decompress every leaf with error feedback."""
    def one(g, e):
        q, s, ne = compress(g, e)
        return decompress(q, s, g.dtype), ne

    return tree_unzip(tree_map(one, grads, err), 2)


def init_error(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def psum_compressed(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-quantized mean over the ranks of ``group`` (JAX's
    ``psum_compressed`` over a pod axis, divided by the axis size as
    there): a MAX all-reduce of the scales puts every rank on one grid,
    the int8-range values travel as an int32 SUM all-reduce.  Without a
    process group (or in a group of one) it is the single-device result."""
    import torch.distributed as dist

    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    distributed = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size(group) if distributed else 1
    if n > 1:
        # max-reduce scales so every participant uses a common grid
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clip(torch.round(x.to(torch.float32) / scale), -127, 127
                   ).to(torch.int32)
    if n > 1:
        dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    total = torch.tensor(float(n), dtype=torch.float32, device=x.device)
    return (q.to(torch.float32) * scale / total).to(x.dtype)
