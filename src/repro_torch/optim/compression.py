"""int8 gradient compression with error feedback: the numerics of the wire
format (``repro.optim.compression``).  ``torch.round`` rounds half to
even, as ``jnp.round`` does.  The collective over a pod axis
(``psum_compressed``) belongs to the mesh tools, which the port has not
taken over yet."""
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
