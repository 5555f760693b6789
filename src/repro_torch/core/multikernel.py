"""Large problem sizes: multi-pass (multi-kernel) tuning (paper §IV-C).

When N exceeds the on-chip working set (a block's resident tile), the
operation decomposes into m passes with device-memory roundtrips between
them. The paper's analytical rule: minimize m = ceil(n / s) (N = r^n,
S = r^s), then tune each pass with the small/medium-size guideline. The ML
route simply widens the space — per-pass tuples are interdependent, but the
surrogate treats the whole vector as one black-box point.

The PyTorch port's own copy of ``repro.core.multikernel``, verbatim in
what it decides: ``analytical_multipass`` applies the minimize-m rule with
the per-pass analytical guideline; ``MultiPassObjective`` scores one
candidate of the large-N space as the sum of its passes for the BO search.
``max_resident_tile`` reads the port's active profile (``h100`` unless
``$REPRO_TORCH_HW_PROFILE`` names another).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

from repro_torch.core.analytical import AnalyticalTuner
from repro_torch.core.objective import (CostModelObjective, Measurement,
                                        Objective, PENALTY_TIME)
from repro_torch.core.space import Config, SearchSpace, Workload, build_space
from repro_torch.hw.profiles import active_profile, dtype_bytes


def num_passes(n: int, tile_n: int, radix: int = 2) -> int:
    """m = ceil(log_r N / log_r S) — radix cancels; depends only on n, s."""
    return max(1, math.ceil(math.log2(max(n, 2)) / math.log2(max(tile_n, 2))))


def max_resident_tile(wl: Workload, spec=None) -> int:
    """Largest power-of-two tile whose double-buffered footprint fits the
    profile's staging budget with at least one problem row per program
    (delegates to the StagePlan layer, which uses the same boundary to
    decide fused vs multi-pass)."""
    from repro_torch.kernels.blocks.plan import resident_tile_cap

    return resident_tile_cap(wl, spec)


@dataclasses.dataclass
class MultiPassPlan:
    workload: Workload
    passes: List[Config]          # one tuned config per pass
    tile_n: int
    m: int
    method: str

    def total_time(self, objective: Objective) -> float:
        t = 0.0
        for cfg in self.passes:
            sub = Workload(op=self.workload.op if self.workload.op != "large_fft" else "fft",
                           n=cfg["tile_n"], batch=self.workload.batch * (self.workload.n // cfg["tile_n"]),
                           dtype=self.workload.dtype, variant=self.workload.variant)
            space = build_space(sub)
            m = objective(space, cfg)
            t += m.time_s if m.valid else PENALTY_TIME
        return t


def analytical_multipass(wl: Workload, spec=None) -> MultiPassPlan:
    """Paper rule: pick the largest S (minimize m), then per-pass guideline."""
    tile = max_resident_tile(wl, spec)
    m = num_passes(wl.n, tile)
    tuner = AnalyticalTuner()
    passes: List[Config] = []
    for _ in range(m):
        sub = Workload(op="fft" if wl.op in ("fft", "large_fft") else wl.op,
                       n=tile, batch=max(wl.batch, 1) * (wl.n // tile),
                       dtype=wl.dtype, variant=wl.variant)
        cfg = tuner.suggest(build_space(sub))
        cfg = dict(cfg)
        cfg["tile_n"] = tile
        passes.append(cfg)
    return MultiPassPlan(wl, passes, tile, m, "analytical")


class MultiPassObjective(Objective):
    """Joint objective for the ML search over the multi-pass space.

    A candidate assigns one (tile_n, radix, rows, unroll) tuple *per pass*
    via suffixed parameter names; passes are summed. Interdependency: the
    tile of pass i fixes the batch reshaping of pass i+1 (modeled through
    the per-pass workload construction), and a mismatched tile chain adds a
    transpose penalty — the "intricacies transparent to the black box".
    """

    def __init__(self, inner: Objective = None):
        self.inner = inner or CostModelObjective()

    def __call__(self, space: SearchSpace, cfg: Config) -> Measurement:
        wl = space.workload
        m = num_passes(wl.n, cfg["tile_n"])
        total = 0.0
        meta: Dict[str, float] = {"m": m}
        elems_left = wl.n
        for i in range(m):
            tile = min(cfg["tile_n"], elems_left)
            sub = Workload(op="fft" if wl.op in ("fft", "large_fft") else wl.op,
                           n=tile, batch=max(wl.batch, 1) * (wl.n // tile),
                           dtype=wl.dtype, variant=wl.variant)
            sub_cfg = dict(cfg)
            sub_cfg["tile_n"] = tile
            sub_space = build_space(sub)
            if not sub_space.is_valid(sub_cfg):
                return Measurement(PENALTY_TIME, False)
            meas = self.inner(sub_space, sub_cfg)
            if not meas.valid:
                return Measurement(PENALTY_TIME, False)
            total += meas.time_s
            elems_left = max(elems_left // tile, 1)
        # inter-pass device-memory transpose roundtrip (billed at the device
        # the inner objective models; active profile when the inner carries
        # no spec)
        spec = getattr(self.inner, "spec", None)
        if spec is None:
            spec = active_profile()
        eb = dtype_bytes(wl.dtype) * (2 if wl.op in ("fft", "large_fft") else 1)
        roundtrip = 2.0 * wl.n * max(wl.batch, 1) * eb / spec.hbm_bandwidth
        total += (m - 1) * roundtrip
        return Measurement(total, True, meta)
