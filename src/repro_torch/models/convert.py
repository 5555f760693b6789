"""Parameters from the JAX package's models into the port's modules.

The JAX package keeps a model's parameters as a nested dict (a pytree) of
arrays, drawn with ``jax.random``, which torch cannot reproduce.  The port
takes them as numpy arrays (``jax.tree.map(np.asarray, params)`` on the
JAX side) and loads them by name: a module's parameter ``in_proj.w`` is
the tree's ``params["in_proj"]["w"]``.  A whole model's tree stacks its
layer groups on a leading axis (``blocks.attn.wq.w`` of shape (n_groups,
d, hq * hd)); ``unstack_groups`` splits it into the port's per-group names
(``blocks.{i}.attn.wq.w``), and ``load_params`` does so for a module whose
``blocks`` (and, for an encoder-decoder, ``enc_blocks``) is a
``ModuleList``.  A hybrid or vlm group holds a list of blocks, which the
names number in turn (``blocks.{i}.blocks.{j}.rec.wx.w``).  This is how
the tests make both packages compute the same block or model.

Training works on the same tree the other way round.  ``param_tree``
gives a model's parameters as the JAX tree (each per-layer parameter
stacked over the groups with ``torch.stack``: the JAX shapes and paths,
``None`` for an ssm group's absent MLP), ``grad_tree`` its gradients in
that layout (zeros where a parameter took no gradient, as ``jax.grad``
gives zeros for an unused parameter), and ``assign_tree`` writes such a
tree back into the modules; the optimizers and the checkpoints work on
this tree.  ``train_state_from_jax`` converts a JAX train state (numpy
leaves) into the port's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.optim.tree import tree_map


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes adds it): move the
        # 16-bit patterns and reinterpret them
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def state_dict_from_params(params: Mapping, prefix: str = ""
                           ) -> Dict[str, torch.Tensor]:
    """Flatten a nested parameter dict of numpy arrays into a state dict
    whose keys join the tree's path with dots."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        key = f"{prefix}{name}"
        if value is None:       # an absent sub-tree (an ssm group's mlp)
            continue
        if isinstance(value, Mapping):
            out.update(state_dict_from_params(value, prefix=key + "."))
        elif isinstance(value, (list, tuple)):
            out.update(state_dict_from_params(
                {str(j): v for j, v in enumerate(value)}, prefix=key + "."))
        else:
            out[key] = _tensor(value)
    return out


def _take(tree, i: int):
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {name: _take(value, i) for name, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_take(value, i) for value in tree]
    return np.asarray(tree)[i]


def unstack_groups(params: Mapping, n_groups: int,
                   key: str = "blocks") -> Dict:
    """The tree with ``params[key]``'s leading group axis split into
    ``{"0": group 0, "1": group 1, ...}``."""
    out = dict(params)
    out[key] = {str(i): _take(params[key], i) for i in range(n_groups)}
    return out


def load_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a JAX parameter tree (numpy leaves) into ``module``: every
    parameter must be present with its shape, and nothing else; each is
    cast to the module's parameter type.  A module whose ``blocks`` or
    ``enc_blocks`` is a ``ModuleList`` (a ``Model``) takes the tree with
    their groups stacked."""
    for key in ("blocks", "enc_blocks"):
        if isinstance(getattr(module, key, None), nn.ModuleList):
            params = unstack_groups(params, len(getattr(module, key)), key)
    state = state_dict_from_params(params)
    own = module.state_dict()
    if sorted(state) != sorted(own):
        raise KeyError(f"parameter names differ: tree {sorted(state)}, "
                       f"module {sorted(own)}")
    for key, value in state.items():
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: tree shape {tuple(value.shape)}, "
                             f"module {tuple(own[key].shape)}")
        state[key] = value.to(own[key].dtype)
    module.load_state_dict(state)
    return module


def _module_tree(module: nn.Module, leaf: Callable[[nn.Parameter], Any]):
    """A module's parameters as a nested dict (lists for ``ModuleList``s),
    ``leaf`` applied to each."""
    from repro_torch.models.model import SSDGroup

    if isinstance(module, nn.ModuleList):
        return [_module_tree(child, leaf) for child in module]
    tree: Dict[str, Any] = {name: leaf(p) for name, p
                            in module._parameters.items() if p is not None}
    for name, child in module._modules.items():
        if child is not None:
            tree[name] = _module_tree(child, leaf)
    if isinstance(module, SSDGroup) and module.mlp is None:
        tree["mlp"] = None          # the JAX group keeps the key, as None
    return tree


def _stacked(module: nn.Module, leaf, copy: bool = False) -> Dict[str, Any]:
    """The tree with ``blocks`` / ``enc_blocks`` stacked (new tensors);
    ``copy`` copies the other leaves too."""
    tree = _module_tree(module, leaf)
    for key, value in tree.items():
        if key in _STACKED and isinstance(getattr(module, key, None),
                                          nn.ModuleList):
            tree[key] = tree_map(lambda *ls: torch.stack(ls), value[0],
                                 *value[1:])
        elif copy:
            tree[key] = tree_map(torch.clone, value)
    return tree


_STACKED = ("blocks", "enc_blocks")


def param_tree(module: nn.Module) -> Dict[str, Any]:
    """The parameters as the JAX package's tree: ``blocks`` (and
    ``enc_blocks``) stacked over the groups; new tensors, detached, which
    later writes into the module leave alone."""
    return _stacked(module, lambda p: p.detach(), copy=True)


def grad_tree(module: nn.Module) -> Dict[str, Any]:
    """The gradients in ``param_tree``'s layout, in each parameter's type;
    zeros where ``.grad`` is None (a parameter the loss did not reach)."""
    return _stacked(module, lambda p: p.grad if p.grad is not None
                    else torch.zeros_like(p))


def _write(module: nn.Module, tree, skip=()) -> None:
    if isinstance(module, nn.ModuleList):
        for child, sub in zip(module, tree):
            _write(child, sub)
        return
    for name, p in module._parameters.items():
        if p is not None:
            if tuple(tree[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: tree shape "
                                 f"{tuple(tree[name].shape)}, module "
                                 f"{tuple(p.shape)}")
            p.copy_(tree[name])
    for name, child in module._modules.items():
        if child is not None and name not in skip:
            _write(child, tree[name])


def assign_tree(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a tree in ``param_tree``'s layout into the module's parameters,
    each cast to its parameter's type (the inverse of ``param_tree``)."""
    stacked = [key for key in _STACKED
               if isinstance(getattr(module, key, None), nn.ModuleList)]
    with torch.no_grad():
        for key in stacked:
            for i, group in enumerate(getattr(module, key)):
                _write(group, tree_map(lambda x, i=i: x[i], tree[key]))
        _write(module, tree, skip=stacked)
    return module


def train_state_from_jax(state: Mapping) -> Dict:
    """A JAX train state with numpy leaves (``jax.tree.map(np.asarray,
    state)``: ``params``, ``opt`` (AdamW's or Adafactor's state), ``step``
    and, with int8 error feedback, ``ef_err``) as the port's, on the CPU."""
    from repro_torch.optim import AdafactorState, AdamWState

    opt = state["opt"]
    kinds = {("mu", "nu", "count"): AdamWState,
             ("vr", "vc", "count"): AdafactorState}
    kind = kinds.get(tuple(getattr(opt, "_fields", ())))
    if kind is None:
        raise TypeError(f"unknown optimizer state {type(opt).__name__}")
    out = {"params": tree_map(_tensor, state["params"]),
           "opt": kind(*(tree_map(_tensor, v) for v in opt)),
           "step": _tensor(state["step"])}
    if "ef_err" in state:
        out["ef_err"] = tree_map(_tensor, state["ef_err"])
    return out
