"""Tuned matmul entry point (TunerSession-driven block shapes).

The PyTorch port of ``repro.kernels.matmul.ops``: ``matmul(a, b)``
resolves (block_m, block_n, block_k) through the default session (op
"matmul", variant "tiled"; M is the workload's batch, N its n, and K
reaches the normalizer through ``dims``) and runs ``matmul_tiled``: the
hand-written kernel (``csrc/matmul.cu``) for a CUDA tensor, its plain
version for a CPU tensor.  No model calls it (the JAX package's layers use
``x @ w`` too); it is the paper's loop on a matrix-unit-bound kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.space import Workload, fit_block, matmul_space
from repro_torch.kernels.matmul.kernel import matmul_tiled
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.tuning import default_session, tuned_kernel


def _normalize(cfg, wl, dims=None):
    """Fit block shapes to (M, N, K); wl carries batch=M, n=N and the entry
    point passes K through ``dims``."""
    dims = dims or {}
    m = int(dims.get("m", wl.batch))
    k = int(dims.get("k", wl.n))
    return {"block_m": fit_block(cfg.get("block_m", 256), m),
            "block_n": fit_block(cfg.get("block_n", 256), wl.n),
            "block_k": fit_block(cfg.get("block_k", 256), k)}


@tuned_kernel("matmul", space=matmul_space, kernel=matmul_tiled,
              reference=matmul_ref, normalize=_normalize, variants=("tiled",))
def matmul(a: torch.Tensor, b: torch.Tensor,
           config: Optional[dict] = None) -> torch.Tensor:
    m, k = a.shape
    _, n = b.shape
    cfg = default_session().resolve(
        Workload(op="matmul", n=n, batch=m, variant="tiled"),
        config=config, dims={"m": m, "k": k})
    return matmul_tiled(a, b, **cfg)
