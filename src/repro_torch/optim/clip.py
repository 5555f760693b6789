"""Global-norm gradient clipping over a tree of tensors: the norm in f32,
each gradient cast back to its own type (``repro.optim.clip``)."""
from __future__ import annotations

import torch

from repro_torch.optim.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    total = sum(torch.sum(torch.square(x.to(torch.float32)))
                for x in tree_leaves(tree))
    # the f32 root correctly rounded, as XLA's: taken in float64 (torch's
    # f32 sqrt on some CPUs misses by an ulp)
    return torch.sqrt(total.to(torch.float64)).to(torch.float32)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.minimum(torch.ones_like(norm),
                          max_norm / torch.clamp(norm, min=1e-9))
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm
