"""Tuned scan entry points: the row-wise prefix sum and linear recurrence.

Every call resolves its configuration through the default
:class:`repro_torch.tuning.TunerSession` — DB hit (offline-tuned), else
the memoized analytical model (online, zero evaluations) — the paper's
deployment flow, then builds the :class:`StagePlan` that fixes the staged
execution (mixed-radix stage sequence, grid, carry).  ``plan.kind ==
"multipass"`` routes large-N workloads through the §IV-C three-launch
driver.  The configuration and the plan are the JAX package's
(``repro.kernels.scan.ops``), computed by the port's own copies.

A CUDA tensor runs the hand-written kernels; a CPU tensor runs their
plain versions through the same plan and launch list.  Shapes are (batch,
n) rows; callers with higher-rank tensors flatten leading dims.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import telemetry
from repro_torch.core.space import Workload, fit_block, scan_space
from repro_torch.kernels.blocks import driver
from repro_torch.kernels.blocks.plan import plan_for
from repro_torch.kernels.scan.kernel import scan_add, scan_linrec
from repro_torch.kernels.scan.ref import scan_add_ref, scan_linrec_assoc_ref
from repro_torch.tuning import default_session, tuned_kernel


def _normalize(cfg, wl, dims=None):
    """Fit tuned knobs to the (batch, n) launch geometry; project to the
    kwargs the scan kernels accept (``in_register`` is a space-only knob;
    linrec's fold order is fixed, so its ``unroll`` is dropped with the
    same variant-awareness its search space applies)."""
    out = {
        "rows_per_program": fit_block(cfg.get("rows_per_program", 8),
                                      max(wl.batch, 1)),
        "tile_n": fit_block(cfg.get("tile_n", wl.n), wl.n),
        "radix": cfg.get("radix", 2),
    }
    if wl.variant != "linrec" and wl.op != "rglru":
        out["unroll"] = cfg.get("unroll", 1)
    if wl.op == "rglru":
        # chain-fusion boundary: keep the knob in the resolved config so
        # the dispatch (and the plan it records) sees the tuned value
        out["fuse"] = cfg.get("fuse", 0)
    return out


def _plan_workload(wl, linrec: bool):
    """Workload the PLAN is built for: the entry points share op="scan"
    and accept any registered variant (DB keys stay caller-chosen), but
    the plan's plane accounting must follow the kernel that actually runs
    — linrec keeps three resident planes, prefix-sum two."""
    want = "linrec" if linrec else ("ks" if wl.variant == "linrec"
                                    else wl.variant)
    return wl if wl.variant == want else dataclasses.replace(wl, variant=want)


@tuned_kernel("scan", space=scan_space, kernel=scan_add,
              reference=scan_add_ref, normalize=_normalize,
              variants=("ks", "lf", "linrec"))
@telemetry.spanned("repro.entry.prefix_sum")
def prefix_sum(x: torch.Tensor, variant: str = "ks",
               config: Optional[dict] = None) -> torch.Tensor:
    """Inclusive row-wise prefix sum with tuned blocking."""
    batch, n = x.shape
    wl = Workload(op="scan", n=n, batch=batch, variant=variant)
    cfg = default_session().resolve(wl, config=config)
    plan = plan_for(_plan_workload(wl, linrec=False), cfg)
    if plan.kind == "multipass":
        return driver.multipass_scan_add(x, plan,
                                         unroll=cfg.get("unroll", 1))
    return driver.launch(scan_add, plan.launches[0], x,
                         rows_per_program=plan.rows, tile_n=plan.tile_n,
                         stages=plan.stages, unroll=cfg.get("unroll", 1))


@tuned_kernel("scan", space=scan_space, kernel=scan_linrec,
              reference=scan_linrec_assoc_ref, normalize=_normalize,
              variants=("ks", "lf", "linrec"))
@telemetry.spanned("repro.entry.linear_recurrence")
def linear_recurrence(a: torch.Tensor, b: torch.Tensor,
                      variant: str = "linrec",
                      config: Optional[dict] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t row-wise with tuned blocking."""
    batch, n = a.shape
    wl = Workload(op="scan", n=n, batch=batch, variant=variant)
    cfg = default_session().resolve(wl, config=config)
    plan = plan_for(_plan_workload(wl, linrec=True), cfg)
    if plan.kind == "multipass":
        return driver.multipass_linrec(a, b, plan)
    return driver.launch(scan_linrec, plan.launches[0], a, b,
                         rows_per_program=plan.rows, tile_n=plan.tile_n,
                         stages=plan.stages)
