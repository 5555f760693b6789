"""Analytical model-driven tuning (paper §IV-A, adapted to the TPU).

The PyTorch port's own copy of ``repro.core.analytical``: the same
TPU-derived guideline, unchanged, so both packages rank every config
identically.  How well it ranks on the H100 is measured by
``compare_methods`` on the card (PERF.md).

Zero-evaluation tuner: scores every valid configuration with an ordinal
occupancy model and returns the argmax. This is the *online* methodology —
it answers immediately from architectural reasoning, exactly like the paper's
guideline answers from the GM20B occupancy table (Fig 3a).

TPU guideline (re-derivation of the paper's four rules):
  1. Prefer configs achieving BOTH full pipeline overlap (>= OVERLAP_GRID
     grid programs, double-buffered VMEM fit) AND full lane utilization.
  2. Else maximize grid parallelism while lane utilization stays in
     [0.60, 1.00] (the paper's warp-occupancy band).
  3. Else maximize lane utilization; among ties prefer larger unroll (ILP).
  4. If the pattern admits a larger radix, prefer it even at reduced grid
     parallelism (fewer passes/sync points, more ILP).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.space import Config, SearchSpace

OVERLAP_GRID = 4          # grid programs needed for full DMA/compute overlap
OCCUPANCY_BAND = (0.60, 1.00)

# keys every resources() dict carries (the plan <-> model contract);
# repro_torch.analysis verifies presence and finiteness for every valid config
# of every op x profile, so the expert model can never silently read a
# missing quantity as 0
RESOURCE_KEYS = ("grid", "vmem", "occupancy", "ilp", "radix", "passes",
                 "block_bytes", "seq_tiles", "stage_count", "steps_per_pass",
                 "ragged", "lane_eff", "sublane_eff")


@dataclasses.dataclass
class AnalyticalScore:
    tier: int              # 3 = rule-1 configs, 2 = rule-2, 1 = rule-3 (higher better)
    pass_rank: float       # paper §IV-C premise: minimize the number of
    #                        passes/kernels FIRST (each extra pass is a full
    #                        HBM roundtrip) — ranks above the radix choice.
    #                        Chain-aware: StagePlan.passes counts XLA chain
    #                        links too (``xla_passes``), so the chain-fusion
    #                        knob (``fuse``) is rewarded here — a fused
    #                        chain's saved HBM pass ranks before any
    #                        blocking preference
    seq_rank: float        # TPU twist on the same premise: a fused carry
    #                        chain serializes its column tiles, so fewer
    #                        sequential tiles rank next
    radix_rank: float      # rule 4
    block_rank: float      # TPU adaptation of the paper's Ba maximization:
    #                        once >= OVERLAP_GRID programs keep the pipeline
    #                        full, BIGGER DMA blocks win (grid programs are
    #                        sequential per core, unlike CUDA blocks/SM)
    occupancy: float
    ilp_rank: float

    def key(self) -> Tuple:
        # Lexicographic: tier, then pass count (§IV-C), then carry-chain
        # depth, then radix (rule 4 overrides block choice), then the
        # tier-specific objective, then ILP tie-break.
        return (self.tier, self.pass_rank, self.seq_rank, self.radix_rank,
                self.block_rank, self.occupancy, self.ilp_rank)


def resources(space: SearchSpace, cfg: Config) -> Dict[str, float]:
    """Architectural resource accounting for one candidate config.

    Everything is read off the :class:`~repro_torch.kernels.blocks.plan.StagePlan`
    — the exact staged execution the kernel drivers will launch — so the
    expert model and the kernels cannot disagree about pass counts, VMEM
    footprints or stage structure.  Public entry point for consumers that
    stack on the analytical model, notably ``repro_torch.tuning.ml.features``.
    """
    # late import: repro_torch.core.__init__ -> analytical must not re-enter
    # blocks.plan while the package is still initializing
    from repro_torch.kernels.blocks.plan import plan_for

    return plan_for(space.workload, cfg, profile=space.spec).resources()


def score(space: SearchSpace, cfg: Config,
          res: Optional[Dict[str, float]] = None) -> AnalyticalScore:
    """Guideline score; pass ``res`` from :func:`resources` to avoid
    recomputing the accounting when the caller already has it."""
    if res is None:
        res = resources(space, cfg)
    spec = space.spec
    fits = res["vmem"] <= spec.vmem_budget
    full_overlap = res["grid"] >= OVERLAP_GRID and fits
    occ = res["occupancy"]
    lo, hi = OCCUPANCY_BAND

    if full_overlap and occ >= 0.999:
        tier = 3
    elif fits and lo <= occ <= hi:
        tier = 2
    elif fits:
        tier = 1
    else:
        tier = 0

    # rule 4: larger radix preferred when it cuts passes/steps — but only
    # stage sequences that stay at the nominal fan-in throughout; a ragged
    # mixed-radix tail needs an extra odd step and more synchronizations
    # (the paper's own observation on WM's jagged performance), so the
    # expert ranks every exact radix above every mixed one.  The raggedness
    # comes from the plan's actual stage sequence, not a re-derivation.
    exact = 0 if res.get("ragged") else 1
    radix_rank = exact * 16.0 + math.log2(max(res["radix"], 2))
    # TPU rule 1/2 objective: biggest DMA block that still leaves the
    # pipeline >= OVERLAP_GRID programs deep (saturating at 4 MiB, past
    # which the DMA ramp is flat).
    if res["grid"] >= OVERLAP_GRID:
        block_rank = math.log2(min(max(res["block_bytes"], 1), 4 * 2**20))
    else:
        block_rank = -1.0   # starves the pipeline: strictly worse
    return AnalyticalScore(tier, -res["passes"],
                           -math.log2(max(res.get("seq_tiles", 1), 1)),
                           radix_rank, block_rank, occ,
                           math.log2(max(res["ilp"], 1)))


class AnalyticalTuner:
    """Ranks the valid space with the guideline; no objective evaluations."""

    name = "analytical"

    def suggest(self, space: SearchSpace) -> Config:
        best: Optional[Config] = None
        best_key: Optional[Tuple] = None
        for cfg in space.enumerate_valid():
            k = score(space, cfg).key()
            if best_key is None or k > best_key:
                best, best_key = cfg, k
        if best is None:
            raise ValueError(f"search space for {space.workload.key} has no valid config")
        return best

    def rank(self, space: SearchSpace, top: int = 5) -> List[Config]:
        cfgs = space.enumerate_valid()
        cfgs.sort(key=lambda c: score(space, c).key(), reverse=True)
        return cfgs[:top]
