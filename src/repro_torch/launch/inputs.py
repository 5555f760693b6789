"""Shape-only stand-ins for every (arch x shape) dry-run cell
(``repro.launch.inputs``).

JAX uses ``ShapeDtypeStruct``s; here the stand-ins are fake tensors
(``torch._subclasses.fake_tensor``): they have a shape, a dtype and a
device, allocate nothing, and run through the model's ops with the shapes
propagated.  They report the CPU device unless the caller names another
(the host mesh's), so the tuned entry points take the plain versions —
what JAX's dry-run lowers — and a dry-run needs no card.  Every stand-in
of one dry-run comes from one ``FakeTensorMode`` (``fake_mode()``), since
fake tensors of two modes do not mix.  Modality frontends are stubs, as in
JAX: audio cells receive precomputed frame embeddings, vlm cells patch
embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.optim.tree import tree_map

PyTree = Any


def fake_mode():
    """A ``FakeTensorMode`` that turns the real tensors a step creates
    (positions, masks) into fake ones when they meet."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _sds(shape, dtype, mode, device="cpu") -> torch.Tensor:
    with mode:
        return torch.empty(shape, dtype=dtype, device=device)


def memory_struct(cfg: ModelConfig, batch: int, mode=None,
                  device="cpu") -> Optional[torch.Tensor]:
    mode = mode or fake_mode()
    if cfg.family == "audio":
        return _sds((batch, cfg.enc_len, cfg.d_model), torch.bfloat16, mode,
                    device)
    if cfg.family == "vlm":
        return _sds((batch, cfg.vision_len, cfg.d_model), torch.bfloat16,
                    mode, device)
    return None


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig, mode=None,
                      device="cpu") -> Dict:
    mode = mode or fake_mode()
    b, s = shape.global_batch, shape.seq_len
    batch = {
        "tokens": _sds((b, s), torch.int32, mode, device),
        "targets": _sds((b, s), torch.int32, mode, device),
        "mask": _sds((b, s), torch.float32, mode, device),
    }
    mem = memory_struct(cfg, b, mode, device)
    if mem is not None:
        batch["memory"] = mem
    return batch


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig, mode=None,
                        device="cpu") -> Dict:
    mode = mode or fake_mode()
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((b, s), torch.int32, mode, device)}
    mem = memory_struct(cfg, b, mode, device)
    if mem is not None:
        batch["memory"] = mem
    return batch


def fake_model(cfg: ModelConfig, mode, device="cpu"):
    """A ``Model`` whose parameters are fake tensors of ``mode``."""
    from repro_torch.models.model import Model

    with mode:
        return Model(cfg, device=device)


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, mode=None,
                       device="cpu", model=None) -> Tuple[Dict, PyTree]:
    """Returns (inputs, cache): one new token against a seq_len cache,
    the cache built by ``Model.init_cache`` under the fake mode (the
    port's layout: a list of one cache a group; ``stacked_cache`` gives
    JAX's)."""
    mode = mode or fake_mode()
    b, s = shape.global_batch, shape.seq_len
    model = model if model is not None else fake_model(cfg, mode, device)
    with mode:
        cache = model.init_cache(b, max_len=s, dtype=torch.bfloat16,
                                 device=device)
    inputs = {"token": _sds((b, 1), torch.int32, mode, device),
              "pos": _sds((b, 1), torch.int32, mode, device)}
    mem = memory_struct(cfg, b, mode, device)
    if mem is not None:
        inputs["memory"] = mem
    return inputs, cache


def stacked_cache(cache: PyTree, mode=None) -> PyTree:
    """A per-group cache in JAX's layout: each leaf stacked over the groups
    (the leading dim), the group's structure kept."""
    def stack(*leaves):
        return torch.stack(leaves)

    if mode is None:
        return tree_map(stack, cache[0], *cache[1:])
    with mode:
        return tree_map(stack, cache[0], *cache[1:])


def abstract_train_state(model, hp, mode=None) -> PyTree:
    """``init_train_state(model, hp)`` on the model's (fake) parameters,
    under ``mode`` so the optimizer's zeros are fake too."""
    from repro_torch.train.step import init_train_state

    if mode is None:
        return init_train_state(model, hp)
    with mode:
        return init_train_state(model, hp)
