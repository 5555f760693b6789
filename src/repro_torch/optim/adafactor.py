"""Adafactor (factored second moment), ``repro.optim.adafactor``: row and
column accumulators for every leaf of two or more axes (a stacked
per-layer vector included, as in JAX), the full second moment for the
rest; ``beta = 1 - t^-decay``, the update's RMS clipped over the whole
leaf, matrices decayed."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.optim.adamw import _device, _lr_fn
from repro_torch.optim.tree import tree_map, tree_unzip

Tree = Any


class AdafactorState(NamedTuple):
    vr: Tree        # row accumulators (or the full v below two axes)
    vc: Tree        # column accumulators (zeros below two axes)
    count: torch.Tensor


def adafactor(lr: Callable | float, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0):
    lr_fn = _lr_fn(lr)

    def init(params: Tree) -> AdafactorState:
        def vr_init(p):
            shape = p.shape[:-1] if p.dim() >= 2 else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vc_init(p):
            shape = p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else ()
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdafactorState(tree_map(vr_init, params),
                              tree_map(vc_init, params),
                              torch.zeros((), dtype=torch.int32,
                                          device=_device(params)))

    def update(grads: Tree, state: AdafactorState, params: Tree
               ) -> Tuple[Tree, AdafactorState]:
        count = state.count + 1
        t = count.to(torch.float32)
        beta = 1.0 - t ** (-decay)
        step_lr = lr_fn(count)

        def upd(g, vr, vc, p):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if p.dim() >= 2:
                vr = beta * vr + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * vc + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.einsum("...r,...c->...rc", vr, vc)
                denom = denom / torch.clamp(
                    torch.mean(vr, dim=-1)[..., None, None], min=1e-30)
                u = g / torch.sqrt(denom + eps)
            else:
                vr = beta * vr + (1 - beta) * g2
                u = g / torch.sqrt(vr + eps)
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay and p.dim() >= 2:
                u = u + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - step_lr * u).to(p.dtype), vr, vc

        new_params, vr, vc = tree_unzip(
            tree_map(upd, grads, state.vr, state.vc, params), 3)
        return new_params, AdafactorState(vr, vc, count)

    return init, update
