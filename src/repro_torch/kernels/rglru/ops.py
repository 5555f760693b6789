"""RG-LRU via the tuned linear-recurrence scan kernels.

``rglru(a, u)`` runs h_t = a_t h_{t-1} + sqrt(1 - a_t^2) u_t over (B, L, D)
by flattening it into (B*D, L) rows for the scan kernels, as
``repro.kernels.rglru.ops.rglru`` does.  The workload resolves through the
TunerSession under its own op name (the space is the linrec-pruned scan
space), builds its StagePlan, and dispatches fused or multipass through
the shared blocks driver, so per-op DB entries and
``overrides(rglru=...)`` apply.

rglru is a gate -> linrec chain: the tuned ``fuse`` knob decides whether
the elementwise gate runs inside the scan kernel's first stage
(``fuse=1``: ``scan_linrec`` / ``scan_linrec_prod`` with ``gate=True``,
one fewer pass over memory) or as a separate torch pass before it
(``fuse=0``).  A CUDA tensor runs the hand-written kernels
(``csrc/linrec.cu``); a CPU tensor runs their plain versions through the
same plan and launch list.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import telemetry
from repro_torch.core.space import Workload, linrec_space
from repro_torch.kernels.blocks import driver
from repro_torch.kernels.blocks.plan import plan_for
from repro_torch.kernels.blocks.primitives import rglru_gate
from repro_torch.kernels.scan.kernel import scan_linrec
from repro_torch.kernels.scan.ops import _normalize as _normalize_scan
from repro_torch.kernels.scan.ref import scan_linrec_assoc_ref
from repro_torch.tuning import default_session, tuned_kernel


@tuned_kernel("rglru", space=linrec_space, kernel=scan_linrec,
              reference=scan_linrec_assoc_ref, normalize=_normalize_scan)
@telemetry.spanned("repro.entry.rglru")
def rglru(a: torch.Tensor, u: torch.Tensor,
          config: Optional[dict] = None) -> torch.Tensor:
    B, L, D = a.shape
    wl = Workload(op="rglru", n=L, batch=B * D)
    cfg = default_session().resolve(wl, config=config)
    plan = plan_for(wl, cfg)
    fused = bool(cfg.get("fuse", 0))
    a_rows = a.permute(0, 2, 1).reshape(B * D, L)
    # fused chain: the second operand is the raw input u and the kernel
    # applies the gate in-tile (gate=True), saving the separate gate pass;
    # unfused, the same gate (root in float64, rounded once) as a torch pass
    b = u if fused else rglru_gate(a, u)
    b_rows = b.permute(0, 2, 1).reshape(B * D, L)
    if plan.kind == "multipass":
        h = driver.multipass_linrec(a_rows, b_rows, plan, gate=fused)
    else:
        h = driver.launch(scan_linrec, plan.launches[0], a_rows, b_rows,
                          rows_per_program=plan.rows, tile_n=plan.tile_n,
                          stages=plan.stages, gate=fused)
    return h.reshape(B, D, L).permute(0, 2, 1)
