"""Sharding hints the models give a distributed step.

The JAX models pin shardings with ``jax.lax.with_sharding_constraint``
where the SPMD partitioner would otherwise choose badly (the batch of the
residual stream, sequence parallelism, the attention scores, the MoE
expert dim).  Here a step is distributed when its tensors are DTensors:
:func:`constrain` redistributes a DTensor to a spec's placements, and is
the identity on a plain tensor, so every single-device path is untouched.

``torch.distributed.tensor`` is never imported at module level: a DTensor
can exist only once that module is loaded (:func:`is_dtensor`, from the
device dispatch below this layer, looks it up in ``sys.modules``).
"""
from __future__ import annotations

import sys
from typing import Sequence

import torch

from repro_torch.tuning.dispatch import is_dtensor


class _Unconstrained:
    """A dim whose sharding the caller leaves as it is (JAX's
    ``PartitionSpec.UNCONSTRAINED``)."""

    def __repr__(self) -> str:
        return "UNCONSTRAINED"


UNCONSTRAINED = _Unconstrained()


def lowering(t) -> bool:
    """True for a tensor that carries no data a kernel could read: a fake
    tensor, or a DTensor whose local shard is one (the dry-run).  Such a
    step lowers the plain-op path, as JAX's dry-run lowers its reference
    on the CPU backend.  A DTensor with real data is not a lowering: it
    goes on to the kernel's wrapper, which refuses it."""
    if is_dtensor(t):
        t = t._local_tensor
    mod = sys.modules.get("torch._subclasses.fake_tensor")
    return mod is not None and isinstance(t, mod.FakeTensor)


def constrain(t: torch.Tensor, axes: Sequence) -> torch.Tensor:
    """``t`` with the sharding of the spec ``axes`` (one entry a dim: an
    axis name, a tuple of names, None or ``sharding.UNCONSTRAINED``).

    A mesh dim that the spec names shards the dim that names it.  A mesh
    dim it does not name keeps its current placement when that placement
    shards an UNCONSTRAINED dim (or is a pending sum), and is replicated
    when it shards a dim the spec pins to None.  Axes the mesh lacks are
    ignored."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    named = {}
    for dim, entry in enumerate(axes):
        if entry is None or entry is UNCONSTRAINED:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis in names:
                named[names.index(axis)] = dim
    target = []
    for m, cur in enumerate(t.placements):
        if m in named:
            target.append(Shard(named[m]))
        elif isinstance(cur, Shard) and axes[cur.dim] is not UNCONSTRAINED:
            target.append(Replicate())
        else:
            target.append(cur)
    if tuple(target) == tuple(t.placements):
        return t
    return t.redistribute(mesh, target)


_BATCH_AXES = ("pod", "data")


def gather_weight(w: torch.Tensor) -> torch.Tensor:
    """A weight with its shards on the batch axes gathered: FSDP's
    all-gather before use (and, in the backward, the reduce-scatter of its
    gradient back to the parameter's shards).  The identity on a plain
    tensor."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    names = w.device_mesh.mesh_dim_names
    target = [Replicate() if names[m] in _BATCH_AXES else p
              for m, p in enumerate(w.placements)]
    if tuple(target) == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, target)


def gather_inner(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every shard of an inner dim (neither the first nor the
    last: the sequence, under sequence parallelism) gathered, SP's
    all-gather before a projection (a reduce-scatter in the backward).  A
    product flattens the leading dims, and a DTensor flattens only a group
    whose first dim alone is sharded.  The identity on a plain tensor."""
    if not is_dtensor(x) or x.dim() < 3:
        return x
    from torch.distributed.tensor import Replicate, Shard

    target = [Replicate() if isinstance(p, Shard)
              and 0 < p.dim < x.dim() - 1 else p for p in x.placements]
    if target == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


class _InnerGatheredGrad(torch.autograd.Function):
    """The identity, whose backward gathers the gradient's inner shards."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return gather_inner(g)


def projection_output(y: torch.Tensor) -> torch.Tensor:
    """A projection's output, whose gradient reaches the product's backward
    with its inner shards gathered: a residual stream sharded on the
    sequence (SP) sends its gradient back so, and the backward flattens it
    as the forward did.  The identity on a plain tensor."""
    if not is_dtensor(y) or y.dim() < 3:
        return y
    return _InnerGatheredGrad.apply(y)


def splittable(x: torch.Tensor, dim: int, lead: int) -> torch.Tensor:
    """``x`` ready to have dim ``dim`` split into (``lead``, rest): a shard
    of that dim on a mesh axis whose size does not divide ``lead`` (a head
    count the model axis does not divide: gemma-2b's 8 on 16) is gathered
    first, as the partitioner would.  The identity on plain tensors."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.dim()
    mesh = x.device_mesh
    target = [Replicate() if isinstance(p, Shard) and p.dim == dim
              and lead % mesh.size(m) else p
              for m, p in enumerate(x.placements)]
    if target == list(x.placements):
        return x
    return x.redistribute(mesh, target)


class _SplittableGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient's last dim
    splittable into ``lead`` (the backward of a merge of two dims)."""

    @staticmethod
    def forward(ctx, y, lead):
        ctx.lead = lead
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return splittable(g, -1, ctx.lead), None


def merged(y: torch.Tensor, lead: int) -> torch.Tensor:
    """``y``, the result of merging (``lead``, rest) into its last dim, with
    a gradient that can be split back (``splittable``).  The identity on a
    plain tensor."""
    if not is_dtensor(y):
        return y
    return _SplittableGrad.apply(y, lead)


def sharded_one_hot(idx: torch.Tensor, n: int, ref: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """``idx[..., None] == arange(n)``: a bool one-hot.  For a DTensor it is
    built on each device from its own rows and its own slice of the n
    classes, sharded on the new last dim as ``ref``'s dim ``dim`` is (the
    vocab, as XLA shards its iota compare), so no device ever holds the
    whole one-hot; DTensor's broadcast rules alone may replicate it."""
    if not is_dtensor(idx):
        return idx[..., None] == torch.arange(n, device=idx.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = idx.device_mesh
    dim = dim % ref.dim()
    split = [m for m, p in enumerate(ref.placements)
             if isinstance(p, Shard) and p.dim == dim]
    if any(isinstance(idx.placements[m], Shard) for m in split):
        idx = idx.redistribute(mesh, [Replicate() if m in split else p
                                      for m, p in enumerate(idx.placements)])
    coord = mesh.get_coordinate()
    part, start = n, 0
    for m in split:                  # major to minor, as DTensor nests
        part //= mesh.size(m)
        start += coord[m] * part
    local = idx.to_local()
    oh = local[..., None] == torch.arange(start, start + part,
                                          device=local.device)
    placements = [Shard(idx.dim()) if m in split else p
                  for m, p in enumerate(idx.placements)]
    shape = tuple(idx.shape) + (n,)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(oh, mesh, placements, run_check=False,
                              shape=shape, stride=tuple(stride))


def place_grads(module: torch.nn.Module) -> None:
    """Redistribute each DTensor gradient to its parameter's placements.

    A backward leaves the gradient of a sharded weight as a pending sum
    over the axes its activations were sharded on; JAX's ``out_shardings``
    put the new parameters (and so the gradients) back on the parameters'
    specs, which is FSDP's reduce-scatter.  No-op for plain tensors."""
    for p in module.parameters():
        g = p.grad
        if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
            p.grad = g.redistribute(p.device_mesh, p.placements)
