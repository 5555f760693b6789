"""Tuned FFT entry points: the resident Stockham kernel and the four-step
large-N driver.

The PyTorch port of ``repro.kernels.fft.ops``.  ``fft(x)`` — x complex
(batch, n):
  * n <= the largest resident tile (``max_resident_tile`` under the port's
    active profile: 8192 points under ``h100``): one Stockham kernel
    launch, radix and rows from the TunerSession (paper §V-C small/medium
    sizes);
  * larger n: the op="large_fft" workload resolves through the same
    session and its StagePlan describes the Bailey four-step decomposition
    N = n1*n2 — executed by ``repro_torch.kernels.blocks.driver
    .four_step_fft`` (the paper's §IV-C multi-kernel strategy with m
    kernels; the tile split n1 comes from the tuned `tile_n`).

A CUDA tensor runs the hand-written kernel (``csrc/fft.cu``); a CPU tensor
runs its plain version through the same plans and launch list.  The
kernel computes in f32 and returns complex64.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import telemetry
from repro_torch.core.multikernel import max_resident_tile
from repro_torch.core.space import Workload, fft_space, large_fft_space
from repro_torch.kernels.blocks import driver
from repro_torch.kernels.blocks.plan import StagePlan, plan_for
from repro_torch.kernels.fft.kernel import fft_stockham
from repro_torch.kernels.fft.ref import fft_ref
from repro_torch.tuning import default_session, tuned_kernel


def _normalize(cfg, wl, dims=None):
    """Raw Stockham knobs; rows are re-fitted per sub-launch (the four-step
    path runs the kernel at several different sub-batch sizes)."""
    return {"radix": cfg.get("radix", 2),
            "rows_per_program": cfg.get("rows_per_program", 4),
            "tile_n": cfg.get("tile_n", 2048)}


def fft_plan(batch: int, n: int, config: Optional[dict] = None) -> StagePlan:
    """The plan ``fft`` runs on (batch, n) rows: one Stockham launch up to
    the resident cap of the active profile, else the four-step plan of the
    op="large_fft" workload, both resolved through the default session."""
    session = default_session()
    wl_small = Workload(op="fft", n=n, batch=batch, variant="stockham")
    max_tile = max_resident_tile(wl_small)
    if n <= max_tile:
        return plan_for(wl_small, session.resolve(wl_small, config=config))
    # ---- four-step multi-kernel path (plan-driven) ----
    wl = Workload(op="large_fft", n=n, batch=batch, variant="stockham")
    return plan_for(wl, session.resolve(wl, config=config), max_tile=max_tile)


@tuned_kernel("fft", space=fft_space, kernel=fft_stockham, reference=fft_ref,
              normalize=_normalize, variants=("stockham",))
@telemetry.spanned("repro.entry.fft")
def fft(x: torch.Tensor, config: Optional[dict] = None,
        inverse: bool = False) -> torch.Tensor:
    batch, n = x.shape
    if not x.is_complex():
        x = x.to(torch.complex64)
    return driver.dispatch_fft(x, fft_plan(batch, n, config), inverse=inverse)


# the four-step driver resolves op="large_fft" through the same session;
# register its space under that name too
tuned_kernel("large_fft", space=large_fft_space, kernel=fft_stockham,
             reference=fft_ref, normalize=_normalize,
             variants=("stockham",))(fft)


def ifft(x: torch.Tensor, config: Optional[dict] = None) -> torch.Tensor:
    return fft(x, config=config, inverse=True)
