"""The port's device policy for tuned kernel entry points.

Replaces ``repro.tuning.dispatch`` (``on_cpu`` / ``plan_execution``),
whose switch chose between a Pallas kernel, interpret mode and the XLA
reference.  Here the tensor's device decides, and nothing else:

  * a CUDA tensor launches the hand-written Hopper kernel, or raises;
  * a CPU tensor runs the kernel's plain PyTorch version through the same
    plan (same launch list, same arithmetic order) — the path the tests
    use, since a CUDA kernel has no interpret mode;
  * any other device raises, and so does a DTensor (a distributed step
    lowers the plain-op path; no kernel is partitioned, in either
    package).

There is no switch that sends a CUDA tensor to the plain version.

A CUDA kernel's output is a fresh tensor that the kernel fills through
ctypes, so autograd would see no path from it to the kernel's inputs and a
backward would silently leave the kernel out.  Every launch site returns
through :func:`no_backward`, which ties the outputs to the inputs with a
function whose backward raises: neither this package nor the JAX package
(reverse mode through ``pallas_call``) has a backward for any kernel.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch


def is_dtensor(t) -> bool:
    """True for a DTensor.  ``torch.distributed.tensor`` is never imported
    here: a DTensor can exist only once that module is loaded, so it is
    looked up in ``sys.modules``."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def is_dtensor_class(cls) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(cls, type) \
        and issubclass(cls, mod.DTensor)


def kernel_path(t: torch.Tensor) -> bool:
    """True when ``t`` must go through the CUDA kernel, False for the plain
    version on the CPU; raises for any other device, and for a DTensor."""
    if is_dtensor(t):
        raise TypeError(
            "a DTensor reached a kernel: the kernels run on one device's "
            "tensors and are not partitioned (the JAX package shard_maps "
            "none); run the distributed step with use_pallas off, or pass "
            "the local shard (DTensor.to_local()) explicitly")
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}: the port runs "
                     f"on 'cuda' (kernels) or 'cpu' (plain versions)")


def resolve_device(name: str = "cuda") -> torch.device:
    """The device an entry point was asked to run on; CUDA unless the caller
    names the CPU, and an error when CUDA was asked for and is absent."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev


class _NoBackward(torch.autograd.Function):
    """The identity on a kernel's outputs, tied to its inputs; its backward
    raises."""

    @staticmethod
    def forward(ctx, name: str, n_out: int, *tensors):
        ctx.name = name
        outs = tensors[:n_out]
        return outs[0] if n_out == 1 else outs

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            f"no backward for the CUDA kernel {ctx.name}: neither this "
            f"package nor the JAX package has a backward for it (reverse "
            f"mode through pallas_call raises there too); train through "
            f"the plain-op path (use_pallas=False) or on the CPU")


def no_backward(name: str, outputs, *inputs: Optional[torch.Tensor]):
    """Return kernel ``name``'s ``outputs`` (a tensor, or a tuple that may
    hold None) unchanged.  When grad mode is on and an input requires grad,
    each output comes back tied to the inputs through a function whose
    backward raises, so a backward through the kernel fails loudly instead
    of dropping the kernel's share of the gradient."""
    if not torch.is_grad_enabled() or not any(
            t is not None and t.requires_grad for t in inputs):
        return outputs
    single = isinstance(outputs, torch.Tensor)
    outs = (outputs,) if single else tuple(outputs)
    live = [i for i, t in enumerate(outs) if t is not None]
    ins = [t for t in inputs if t is not None and t.requires_grad]
    tied = _NoBackward.apply(name, len(live), *(outs[i] for i in live), *ins)
    tied = (tied,) if len(live) == 1 else tied
    merged = list(outs)
    for i, t in zip(live, tied):
        merged[i] = t
    return merged[0] if single else tuple(merged)
