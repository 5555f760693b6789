"""Library oracle for the scan kernel family: the inclusive prefix sum of
each row of a (batch, n) tensor, as ``repro.kernels.scan.ref`` defines it
with ``jnp.cumsum``.  It checks the kernels; no entry point calls it."""
from __future__ import annotations

import torch


def scan_add_ref(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis."""
    return torch.cumsum(x, dim=-1)
