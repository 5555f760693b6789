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
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


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
