"""The port's device policy for tuned kernel entry points.

Replaces ``repro.tuning.dispatch`` (``on_cpu`` / ``plan_execution``),
whose switch chose between a Pallas kernel, interpret mode and the XLA
reference.  Here the tensor's device decides, and nothing else:

  * a CUDA tensor launches the hand-written Hopper kernel, or raises;
  * a CPU tensor runs the kernel's plain PyTorch version through the same
    plan (same launch list, same arithmetic order) — the path the tests
    use, since a CUDA kernel has no interpret mode;
  * any other device raises.

There is no switch that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch


def kernel_path(t: torch.Tensor) -> bool:
    """True when ``t`` must go through the CUDA kernel, False for the plain
    version on the CPU; raises for any other device."""
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
