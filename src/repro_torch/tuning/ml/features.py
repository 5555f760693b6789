"""Deterministic featurization of (Workload, candidate Config) pairs.

The learned predictor (paper §IV-B's offline-ML methodology, re-targeted at
config *prediction* instead of config *search*) never sees raw dicts: every
candidate is encoded as a fixed-length float vector whose layout is frozen
by ``FEATURE_NAMES``. Two design rules:

  * log2-encode every power-of-two knob and dimension — sizes span four
    orders of magnitude and trees split far better on the exponent;
  * stack on the analytical model: the occupancy / lane-utilization /
    grid-depth / pass-count quantities from ``repro_torch.core.analytical`` are
    features, so the forest learns *corrections to the expert model*
    rather than re-deriving TPU architecture from scratch.

The encoding is pure and deterministic (no RNG, no wall clock), so a row
computed at train time is bit-identical to the row computed online — the
model artifact stays valid as long as ``FEATURE_VERSION`` matches.

The PyTorch port's own copy of ``repro.tuning.ml.features``: it reads the
port's plans, scores and profiles (``h100`` included, whose device columns
differ from every other profile's), so both packages encode a candidate
to the same row under the same profile.
"""
from __future__ import annotations

import math
import zlib
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.analytical import score
from repro_torch.core.space import Config, SearchSpace
from repro_torch.hw.profiles import dma_efficiency, dtype_bytes, ilp_factor
from repro_torch.kernels.blocks.plan import plan_for

# Bump whenever FEATURE_NAMES or any encoding rule changes; artifacts carry
# the version and loading a stale one fails fast instead of mis-predicting.
# v4: device feature columns (hardware-profile geometry/limits), so one
# forest can pool rows measured on different profiles.
# v5: "fuse" column — the chain-fusion boundary knob (ssd/rglru chains);
# the plan columns (log2_passes) already see its effect, the raw knob lets
# the forest separate fusion from blocking at equal pass counts.
FEATURE_VERSION = 5

FEATURE_NAMES = (
    # workload (Input Parameters `A`)
    "log2_n", "log2_batch", "dtype_bytes", "variant_id",
    # raw knobs (Performance Parameters `B`); 0.0 when a knob is absent
    "log2_tile_n", "log2_rows", "log2_radix", "log2_unroll", "in_register",
    "fuse",
    "log2_block_q", "log2_block_k", "log2_block_m", "log2_block_n",
    # StagePlan stack (the exact staged execution the drivers launch:
    # launches/HBM passes, stage count, carry-chain depth, raggedness,
    # VMEM) + the guideline score computed on the same plan
    "log2_grid", "log2_vmem", "occupancy", "log2_ilp", "log2_passes",
    "log2_block_bytes", "steps_per_pass", "vmem_fits",
    "log2_seq_tiles", "ragged_tail",
    "tier", "radix_rank", "block_rank", "ilp_rank",
    # machine-model response curves (hw.profiles): the expert model's own
    # efficiency terms, so the forest corrects them instead of re-learning
    "dma_eff", "ilp_eff", "lane_util", "sublane_util",
    "log2_total_bytes", "log2_t_mem_proxy", "log2_steps_total",
    # scale-invariant knob ratios: log2(knob / the dim it divides).
    # Absolute tile_n=512 means "one pass" at N=512 but "half the problem"
    # at N=1024 — the ratio is what generalizes to unseen N (0.0 when the
    # knob is absent from the op's space).
    "rel_tile_n", "rel_rows", "rel_block_q", "rel_block_k",
    "rel_block_m", "rel_block_n",
    # space-context features (filled by featurize_batch): this candidate's
    # standing *relative to the alternatives in its own space*. A
    # per-candidate regressor cannot otherwise express "largest exact radix
    # AVAILABLE at this N" — the winning radix at an unseen size may never
    # have been the winner at any training size, but "radix_rank_rel == 0"
    # transfers exactly.
    "ana_rank_pct", "tier_rel", "radix_rank_rel", "block_rank_rel",
    "dma_eff_rel",
    # device columns (the space's hardware profile): constant within one
    # profile — a single-device forest never splits on them — but they let
    # one forest pool rows measured on different devices and learn
    # hardware-conditioned corrections (the paper's portability story).
    "dev_log2_vmem_budget", "dev_log2_lanes", "dev_log2_sublanes",
    "dev_log2_mxu", "dev_log2_bw", "dev_log2_flops_bytes",
    "dev_log2_launch_ns", "dev_log2_sync_ns",
)

N_FEATURES = len(FEATURE_NAMES)

_LOG2_KNOBS = (
    ("log2_tile_n", "tile_n"), ("log2_rows", "rows_per_program"),
    ("log2_radix", "radix"), ("log2_unroll", "unroll"),
    ("log2_block_q", "block_q"), ("log2_block_k", "block_k"),
    ("log2_block_m", "block_m"), ("log2_block_n", "block_n"),
)


def _log2(v: float) -> float:
    return math.log2(v) if v > 0 else 0.0


def variant_id(variant: str) -> float:
    """Stable small numeric id for the workload variant (categorical)."""
    if not variant:
        return 0.0
    return float(zlib.crc32(variant.encode()) % 97 + 1)


def _encode(space: SearchSpace, cfg: Mapping[str, int]):
    """(feature row, analytical score) — one StagePlan per candidate.

    Every architectural quantity is read off the plan (the same object the
    kernel drivers execute), so train-time rows, predict-time rows, and
    the launched kernels all agree; the only additions are the machine
    model's response curves evaluated AT the plan's operating point.
    """
    wl = space.workload
    plan = plan_for(wl, cfg, profile=space.spec)
    res = plan.resources()
    sc = score(space, dict(cfg), res=res)

    spec = space.spec
    block_bytes = max(float(plan.block_bytes), 1.0)
    dma_eff = dma_efficiency(int(block_bytes), spec)
    # bytes the whole problem moves per HBM pass (read+write), the
    # numerator of the machine model's memory term
    total_bytes = 2.0 * plan.batch * wl.n * plan.element_bytes * plan.passes
    t_mem_proxy = total_bytes / (spec.hbm_bandwidth * max(dma_eff, 1e-6))

    row = {
        "log2_n": _log2(wl.n),
        "log2_batch": _log2(max(wl.batch, 1)),
        "dtype_bytes": float(dtype_bytes(wl.dtype)),
        "variant_id": variant_id(wl.variant),
        "in_register": float(cfg.get("in_register", 0)),
        "fuse": float(cfg.get("fuse", 0)),
        "log2_grid": _log2(res["grid"]),
        "log2_vmem": _log2(res["vmem"]),
        "occupancy": float(res["occupancy"]),
        "log2_ilp": _log2(max(res["ilp"], 1)),
        "log2_passes": _log2(max(res["passes"], 1)),
        "log2_block_bytes": _log2(block_bytes),
        "steps_per_pass": float(res["steps_per_pass"]),
        "vmem_fits": 1.0 if res["vmem"] <= space.spec.vmem_budget else 0.0,
        "log2_seq_tiles": _log2(max(res["seq_tiles"], 1)),
        "ragged_tail": float(res["ragged"]),
        "tier": float(sc.tier),
        "radix_rank": float(sc.radix_rank),
        "block_rank": float(sc.block_rank),
        "ilp_rank": float(sc.ilp_rank),
        "dma_eff": float(dma_eff),
        "ilp_eff": float(ilp_factor(int(cfg.get("unroll", 1)), spec)),
        "lane_util": float(res["lane_eff"]),
        "sublane_util": float(res["sublane_eff"]),
        "log2_total_bytes": _log2(total_bytes),
        "log2_t_mem_proxy": _log2(max(t_mem_proxy, 1e-12)),
        "log2_steps_total": _log2(
            max(res["passes"] * max(res["steps_per_pass"], 1.0), 1.0)),
    }
    for feat, knob in _LOG2_KNOBS:
        row[feat] = _log2(cfg[knob]) if knob in cfg else 0.0
    batch = max(wl.batch, 1)
    for feat, knob, denom in (
            ("rel_tile_n", "tile_n", wl.n), ("rel_rows", "rows_per_program", batch),
            ("rel_block_q", "block_q", wl.n), ("rel_block_k", "block_k", wl.n),
            ("rel_block_m", "block_m", batch), ("rel_block_n", "block_n", wl.n)):
        row[feat] = _log2(cfg[knob]) - _log2(denom) if knob in cfg else 0.0
    # neutral context defaults; featurize_batch overwrites with real standing
    row["ana_rank_pct"] = 1.0
    row["tier_rel"] = 0.0
    row["radix_rank_rel"] = 0.0
    row["block_rank_rel"] = 0.0
    row["dma_eff_rel"] = 0.0
    # device columns: the profile this space (and therefore this row's
    # label) was bounded/measured by
    row["dev_log2_vmem_budget"] = _log2(spec.vmem_budget)
    row["dev_log2_lanes"] = _log2(spec.lane_count)
    row["dev_log2_sublanes"] = _log2(spec.sublane_count)
    row["dev_log2_mxu"] = _log2(spec.mxu_dim)
    row["dev_log2_bw"] = _log2(spec.hbm_bandwidth)
    # machine balance (vector flops per HBM byte): the roofline knee
    row["dev_log2_flops_bytes"] = _log2(spec.peak_vpu_flops
                                        / spec.hbm_bandwidth)
    row["dev_log2_launch_ns"] = _log2(spec.kernel_launch_s * 1e9)
    row["dev_log2_sync_ns"] = _log2(spec.pass_sync_s * 1e9)
    return (np.array([row[name] for name in FEATURE_NAMES],
                     dtype=np.float64), sc)


def featurize(space: SearchSpace, cfg: Mapping[str, int]) -> np.ndarray:
    """One candidate -> one float64 row in ``FEATURE_NAMES`` order.

    The trailing space-context features are neutral here (best-possible
    standing); use :func:`featurize_batch` over the full candidate set —
    as the dataset builder and the strategy both do — whenever relative
    standing should be real.
    """
    return _encode(space, cfg)[0]


_CONTEXT_COLS = {name: FEATURE_NAMES.index(name) for name in
                 ("ana_rank_pct", "tier_rel", "radix_rank_rel",
                  "block_rank_rel", "dma_eff_rel")}
_TIER_COL = FEATURE_NAMES.index("tier")
_RADIX_RANK_COL = FEATURE_NAMES.index("radix_rank")
_BLOCK_RANK_COL = FEATURE_NAMES.index("block_rank")
_DMA_EFF_COL = FEATURE_NAMES.index("dma_eff")


def featurize_batch(space: SearchSpace,
                    cfgs: Sequence[Config]) -> np.ndarray:
    """Encode the candidates of one space; shape (len(cfgs), N_FEATURES).

    Fills the space-context columns from the batch itself: the analytical
    ordering percentile and each candidate's tier/radix/block rank relative
    to the best value present among ``cfgs``.
    """
    if not cfgs:
        return np.empty((0, N_FEATURES), dtype=np.float64)
    encoded = [_encode(space, c) for c in cfgs]
    X = np.stack([row for row, _ in encoded])
    keys = [sc.key() for _, sc in encoded]
    order = sorted(range(len(keys)), key=keys.__getitem__, reverse=True)
    pct = np.empty(len(keys))
    denom = max(len(keys) - 1, 1)
    for rank, i in enumerate(order):
        pct[i] = 1.0 - rank / denom
    X[:, _CONTEXT_COLS["ana_rank_pct"]] = pct
    X[:, _CONTEXT_COLS["tier_rel"]] = X[:, _TIER_COL] - X[:, _TIER_COL].max()
    X[:, _CONTEXT_COLS["radix_rank_rel"]] = \
        X[:, _RADIX_RANK_COL] - X[:, _RADIX_RANK_COL].max()
    X[:, _CONTEXT_COLS["block_rank_rel"]] = \
        X[:, _BLOCK_RANK_COL] - X[:, _BLOCK_RANK_COL].max()
    X[:, _CONTEXT_COLS["dma_eff_rel"]] = \
        X[:, _DMA_EFF_COL] - X[:, _DMA_EFF_COL].max()
    return X
