"""Analytical model-driven tuning (paper §IV-A, adapted to the TPU).

The PyTorch port's own copy of ``repro.core.analytical``: the TPU-derived
guideline below, plus one term for CUDA cards.  Under a profile whose
``backend`` is ``"cuda"`` the SSD is ranked, right after the tier, by
the modelled time of its chain (:func:`ssd_chain_time`): the guideline's
"fewest passes first" holds for a linear scan, whose work inside a tile
does not grow with the tile, but the SSD's masked intra-chunk products
grow with the chunk, and on the card that work outweighs a pass.  Every
other op, and the SSD under the three profiles the JAX package shares
(``tpu_v5e``, ``gpu_sm``, ``cpu_interpret``), ranks as JAX ranks it.
How well it ranks on the H100 is measured by ``compare_methods`` on the
card (PERF.md).

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
# The SSD's state and head widths for its chain time: a Workload carries
# neither, so the term assumes Mamba-2's published d_state and head dim.
# The ranking leans on them only where a pass's fixed cost meets the
# intra-chunk work; the intra share grows with the chunk whatever they are.
SSD_STATE = 128
SSD_HEAD_DIM = 64

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
    chain_time: Optional[float] = None  # the SSD's modelled chain seconds
    #                                     on a CUDA card; None elsewhere

    def key(self) -> Tuple:
        # Lexicographic: tier, then (the SSD on a CUDA card) the chain's
        # modelled time, then pass count (§IV-C), then carry-chain depth,
        # then radix (rule 4 overrides block choice), then the
        # tier-specific objective, then ILP tie-break.
        rest = (self.pass_rank, self.seq_rank, self.radix_rank,
                self.block_rank, self.occupancy, self.ilp_rank)
        if self.chain_time is None:
            return (self.tier,) + rest
        return (self.tier, -self.chain_time) + rest


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


def ssd_chain_time(space: SearchSpace, res: Dict[str, float]) -> float:
    """Modelled seconds of one SSD chain (intra -> state -> apply).

    The intra-chunk work is the two masked chunk x chunk products, C B^T
    over the state and its decay-weighted product with x over the head:
    (S + P) flops a row, token and unit of chunk, at ``peak_vpu_flops``.
    Each pass adds a launch, a sync and one HBM round trip of a (rows, L,
    P) f32 plane.  Chunk and passes come from the plan's accounting
    (``seq_tiles`` is the chunk count; ``tile_divides_n`` makes it exact).
    """
    spec, wl = space.spec, space.workload
    rows, length = max(wl.batch, 1), wl.n
    chunk = length / max(res["seq_tiles"], 1)
    intra = rows * length * chunk * (SSD_STATE + SSD_HEAD_DIM) \
        / spec.peak_vpu_flops
    trip = 2 * rows * length * SSD_HEAD_DIM * 4 / spec.hbm_bandwidth
    return intra + res["passes"] * (spec.kernel_launch_s + spec.pass_sync_s
                                    + trip)


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
    chain_time = None
    if space.workload.op == "ssd" and spec.backend == "cuda":
        chain_time = ssd_chain_time(space, res)
    return AnalyticalScore(tier, -res["passes"],
                           -math.log2(max(res.get("seq_tiles", 1), 1)),
                           radix_rank, block_rank, occ,
                           math.log2(max(res["ilp"], 1)), chain_time)


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
