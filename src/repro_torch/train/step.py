"""The train step and the serving steps of the port (``repro.train.step``).

The JAX step is a pure function of (state, batch) under ``jax.jit``; here
a ``Model`` holds its parameters, and the step moves them through the JAX
package's tree (``models.convert``): it writes ``state["params"]`` into
the model when it is not the tree the step wrote last, runs the loss
forward and ``backward``, reads the gradients as a tree (``grad_tree``:
zeros for a parameter the loss did not reach, as ``jax.grad`` gives),
and after int8 error feedback, clipping and the optimizer's update,
writes the new parameters back (``assign_tree``).  In a distributed
step (DTensor parameters) each gradient goes to its parameter's placements
before it is read (``distributed.hints.place_grads``).  The state is JAX's:
``{"params", "opt", "step"}`` and, with ``int8_ef``, ``"ef_err"``.

Gradients through a CUDA kernel raise (``tuning.dispatch.no_backward``):
neither package has a backward for any kernel, so on the card a model
trains with ``use_pallas=False`` (plain-op attention, JAX's default), and
the ssm and hybrid families, whose forward reaches a kernel on any
accelerator, train on the CPU only, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed.hints import (is_dtensor, place_grads,
                                          sharded_one_hot)
from repro_torch.models.convert import assign_tree, grad_tree, param_tree
from repro_torch.models.model import Model
from repro_torch.optim import (adafactor, adamw, clip_by_global_norm,
                               warmup_cosine)
from repro_torch.optim.compression import ef_roundtrip, init_error
from repro_torch.optim.tree import tree_map

Tree = Any
METRICS = ("nll", "accuracy", "tokens", "loss", "aux")


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    clip_norm: float = 1.0
    weight_decay: float = 0.1
    aux_weight: float = 0.01          # MoE load-balance loss weight
    z_weight: float = 1e-4            # z-loss (logit norm regularizer)
    micro_steps: int = 1              # gradient accumulation
    optimizer: str = "adamw"          # adamw | adafactor
    grad_compression: str = "none"    # none | int8_ef


def make_optimizer(hp: TrainHParams):
    lr = warmup_cosine(hp.peak_lr, hp.warmup_steps, hp.total_steps)
    if hp.optimizer == "adamw":
        return adamw(lr, weight_decay=hp.weight_decay)
    if hp.optimizer == "adafactor":
        return adafactor(lr, weight_decay=hp.weight_decay)
    raise ValueError(hp.optimizer)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor, z_weight: float = 0.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits f32 (B, L, V), targets (B, L), mask (B, L) f32."""
    if is_dtensor(logits):
        # over a vocab-sharded DTensor: JAX's logsumexp as jnp writes it,
        # a max and a sum that each reduce across the shards
        top = torch.amax(logits, dim=-1, keepdim=True).detach()
        lse = torch.log(torch.sum(torch.exp(logits - top), dim=-1)) \
            + top[..., 0]
    else:
        lse = torch.logsumexp(logits, dim=-1)                      # (B, L)
    # the label logit: JAX sums a one-hot select over the vocab, which
    # adds zeros to the one logit; a gather reads the same value.  Over a
    # vocab-sharded DTensor the select partitions (each device sums its
    # slice) where a gather would not, so a distributed step takes it.
    if is_dtensor(logits):
        onehot = sharded_one_hot(targets, logits.shape[-1], logits, -1)
        label_logit = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    else:
        label_logit = torch.gather(logits, -1,
                                   targets[..., None].long())[..., 0]
    nll = lse - label_logit
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll * mask) / denom
    if z_weight:
        loss = loss + z_weight * torch.sum((lse * lse) * mask) / denom
    # accuracy without argmax: the label logit reaches the row's maximum
    max_logit = torch.amax(logits, dim=-1)
    acc = torch.sum((label_logit >= max_logit) * mask) / denom
    return loss, {"nll": torch.sum(nll * mask) / denom, "accuracy": acc,
                  "tokens": denom}


def _device(model: Model) -> torch.device:
    return model.final_norm.device


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_loss_fn(model: Model, hp: TrainHParams) -> Callable:
    """``loss_fn(batch) -> (total, metrics)`` on the model's current
    parameters; the metrics are detached."""
    def loss_fn(batch: Dict[str, torch.Tensor]):
        logits, aux = model(batch["tokens"], memory=batch.get("memory"))
        loss, metrics = cross_entropy(logits, batch["targets"],
                                      batch["mask"], hp.z_weight)
        total = loss + hp.aux_weight * aux
        metrics = dict(metrics, loss=loss, aux=aux)
        return total, {k: v.detach() for k, v in metrics.items()}

    return loss_fn


def init_train_state(model: Model, hp: TrainHParams,
                     generator: Optional[torch.Generator] = None) -> Dict:
    """``{"params", "opt", "step"}`` (and ``"ef_err"`` with int8 error
    feedback) for ``model``: its weights drawn anew from ``generator`` (on
    the model's device), or the ones it holds when ``generator`` is None."""
    if generator is not None:
        model.reset(generator)
    params = param_tree(model)
    opt_init, _ = make_optimizer(hp)
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=_device(model))}
    if hp.grad_compression == "int8_ef":
        state["ef_err"] = init_error(params)
    return state


def _grads(model: Model, loss_fn: Callable, batch: Dict):
    model.zero_grad(set_to_none=True)
    total, metrics = loss_fn(batch)
    try:
        total.backward()
    except BaseException:
        # a backward that raises (through a kernel's guard) leaves no
        # partial gradient behind
        model.zero_grad(set_to_none=True)
        raise
    place_grads(model)
    return grad_tree(model), metrics


def _micro_batch(v: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Micro step ``i`` of ``n``: contiguous rows, as JAX splits the batch.
    A batch-sharded DTensor takes every n-th row instead, which each device
    cuts from its own rows; the accumulated gradient is the same mean over
    all rows."""
    if is_dtensor(v):
        return v.reshape((v.shape[0] // n, n) + v.shape[1:])[:, i]
    return v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]


def make_train_step(model: Model, hp: TrainHParams) -> Callable:
    """``train_step(state, batch) -> (new_state, metrics)``; the batch may
    hold numpy arrays or tensors, which move to the model's device."""
    loss_fn = make_loss_fn(model, hp)
    _, opt_update = make_optimizer(hp)
    written = [None]            # the params tree the step wrote last

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        if params is not written[0]:
            assign_tree(model, params)
        batch = _to_device(batch, _device(model))

        if hp.micro_steps > 1:
            n = hp.micro_steps
            # contiguous rows per micro step, grads accumulated in f32
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            metrics = {k: torch.zeros((), dtype=torch.float32,
                                      device=_device(model)) for k in METRICS}
            for i in range(n):
                mb = {k: _micro_batch(v, n, i) for k, v in batch.items()}
                g, m = _grads(model, loss_fn, mb)
                grads = tree_map(lambda a, b: a + b.to(torch.float32),
                                 grads, g)
                metrics = {k: metrics[k] + m[k] for k in METRICS}
            grads = tree_map(lambda g: g / n, grads)
            metrics = {k: v / n for k, v in metrics.items()}
        else:
            grads, metrics = _grads(model, loss_fn, batch)
        model.zero_grad(set_to_none=True)

        if hp.grad_compression == "int8_ef":
            grads, new_err = ef_roundtrip(grads, state["ef_err"])

        grads, gnorm = clip_by_global_norm(grads, hp.clip_norm)
        new_params, new_opt = opt_update(grads, state["opt"], params)
        assign_tree(model, new_params)
        written[0] = new_params
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if hp.grad_compression == "int8_ef":
            new_state["ef_err"] = new_err
        metrics = dict(metrics, grad_norm=gnorm)
        return new_state, metrics

    return train_step


def make_prefill_step(model: Model) -> Callable:
    """``prefill_step(batch) -> logits[:, -1]`` on the model's parameters."""
    def prefill_step(batch: Dict) -> torch.Tensor:
        batch = _to_device(batch, _device(model))
        with torch.no_grad():
            logits, _ = model(batch["tokens"], memory=batch.get("memory"))
        return logits[:, -1]

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    """``decode_step(token, cache, pos, memory=None) -> (logits[:, 0],
    new_cache)``."""
    def decode_step(token, cache, pos, memory=None):
        with torch.no_grad():
            logits, new_cache = model.decode_step(token, cache, pos,
                                                  memory=memory)
        return logits[:, 0], new_cache

    return decode_step
