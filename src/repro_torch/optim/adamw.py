"""AdamW with f32 state over a tree of parameters (``repro.optim.adamw``).

The tree is the JAX package's: ``models.convert.param_tree`` stacks each
per-layer parameter over the layer groups, so "decay matrices only"
(``p.ndim >= 2``) decays a stacked norm scale, bias or ``lambda`` as the
JAX optimizer does, and leaves the top-level ``final_norm`` alone.  The
new parameter is ``(p.f32 - lr * delta)`` cast to the parameter's type:
no master copy, as in JAX.  ``torch.optim.AdamW`` keeps its state in the
parameter's type and decays every tensor, so it computes something else.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.optim.tree import tree_leaves, tree_map, tree_unzip

Tree = Any


class AdamWState(NamedTuple):
    mu: Tree
    nu: Tree
    count: torch.Tensor


def _lr_fn(lr):
    if callable(lr):
        return lr
    return lambda count: torch.full((), lr, dtype=torch.float32,
                                    device=count.device)


def _device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1):
    lr_fn = _lr_fn(lr)

    def init(params: Tree) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        return AdamWState(mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params),
                          count=torch.zeros((), dtype=torch.int32,
                                            device=_device(params)))

    def update(grads: Tree, state: AdamWState, params: Tree
               ) -> Tuple[Tree, AdamWState]:
        count = state.count + 1
        t = count.to(torch.float32)
        step_lr = lr_fn(count)

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            delta = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay and p.dim() >= 2:   # decay matrices only
                delta = delta + weight_decay * p.to(torch.float32)
            new_p = (p.to(torch.float32) - step_lr * delta).to(p.dtype)
            return new_p, m, v

        new_params, mu, nu = tree_unzip(
            tree_map(upd, grads, state.mu, state.nu, params), 3)
        return new_params, AdamWState(mu, nu, count)

    return init, update
