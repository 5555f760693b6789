"""Labeled training data for the learned config predictor.

Two sources, mirroring the paper's offline pipeline:

  * **exhaustive sweeps** (``core/exhaustive.py`` semantics): every valid
    config of a workload's space evaluated on the offline objective — the
    dense signal the forest actually learns the ranking from;
  * **TuningDB records**: the winners persisted by earlier offline tuning
    runs; sparse (one config per workload) but real, so they ride along.

Labels are ``log(slowdown)`` vs the workload group's best config: the
winner of every group sits at exactly 0.0.  Prediction is only ever
*compared within one workload* — pinning the winner to one aligned level
across groups removes the absolute-scale burden (times span four orders
of magnitude across N) and spends all model capacity on the ranking,
which is what top-1 match and slowdown measure.

Splits follow the paper's generalization axis: train on problem sizes
{N_train}, evaluate on *unseen* sizes — never a random row split, which
would leak every size into training.

The PyTorch port's own copy of ``repro.tuning.ml.dataset``: the same
journals give the same rows and labels, under every policy.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.paper_ops import TOTAL_ELEMS
from repro_torch.core.objective import CostModelObjective, Objective
from repro_torch.core.space import Config, Workload, build_space
from repro_torch.tuning.db import TuningDB
from repro_torch.tuning.ml.features import N_FEATURES, featurize_batch
from repro_torch.tuning.sweep import SweepJournal, config_key, run_sweep

# ---------------------------------------------------------------------------
# Default suite: per-op train / holdout problem sizes (paper Table I sizes)
# ---------------------------------------------------------------------------
# Holdout sizes sit strictly *between or beyond* train sizes so eval-model
# measures interpolation/extrapolation to unseen N, not memorization.

SUITE: Dict[str, Dict] = {
    "scan": {"variants": ("lf", "ks", "linrec"),
             "train": (128, 256, 1024, 2048), "holdout": (512, 4096)},
    "ssd": {"variants": ("",), "train": (256, 1024), "holdout": (512,)},
    "rglru": {"variants": ("",), "train": (256, 1024), "holdout": (512,)},
    "tridiag": {"variants": ("cr", "pcr", "wm"),
                "train": (64, 128, 512, 1024), "holdout": (256,)},
    "fft": {"variants": ("stockham",),
            "train": (64, 128, 512, 2048, 4096), "holdout": (256, 1024)},
    "large_fft": {"variants": ("stockham",),
                  "train": (8192, 1048576, 8388608), "holdout": (65536,)},
    "attention": {"variants": ("flash",),
                  "train": (512, 1024, 4096), "holdout": (2048,),
                  "batch": 64},
    "matmul": {"variants": ("",),
               "train": (512, 2048), "holdout": (1024,), "batch": 1024},
}


# Ops that share a search space and cost structure train one pooled forest
# (tripling the scan family's rows); ModelBundle.meta["aliases"] routes
# lookups for the aliased ops back to the pooled key.
POOLED_OPS: Dict[str, str] = {"ssd": "scan", "rglru": "scan"}


def _batch_for(op: str, n: int) -> int:
    fixed = SUITE.get(op, {}).get("batch")
    return int(fixed) if fixed else max(TOTAL_ELEMS // n, 1)


def suite_workloads(split: str = "train",
                    ops: Optional[Iterable[str]] = None) -> List[Workload]:
    """The default (op, variant, size) grid for one split."""
    assert split in ("train", "holdout"), split
    selected = list(ops) if ops else list(SUITE)
    unknown = [op for op in selected if op not in SUITE]
    if unknown:
        raise ValueError(f"unknown op(s) {', '.join(map(repr, unknown))}; "
                         f"known: {', '.join(sorted(SUITE))}")
    out = []
    for op in selected:
        spec = SUITE[op]
        for variant in spec["variants"]:
            for n in spec[split]:
                out.append(Workload(op=op, n=n, batch=_batch_for(op, n),
                                    variant=variant))
    return out


# ---------------------------------------------------------------------------
# Dataset container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Dataset:
    """Feature rows + labels, grouped by workload key."""

    X: np.ndarray                         # (rows, N_FEATURES)
    y: np.ndarray                         # (rows,) log-time, group-centered
    group: np.ndarray                     # (rows,) index into .keys
    keys: List[str]                       # workload key per group
    ops: List[str]                        # op per group

    def __len__(self) -> int:
        return len(self.y)

    def by_op(self, pool: Optional[Dict[str, str]] = None
              ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """Per-op (X, y) splits for ``forest.train_bundle``.

        ``pool`` merges rows of aliased ops into their pooled key (default:
        ``POOLED_OPS``); pass ``{}`` to keep every op separate.
        """
        pool = POOLED_OPS if pool is None else pool
        out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        op_per_row = np.array([pool.get(self.ops[g], self.ops[g])
                               for g in self.group])
        for op in sorted(set(op_per_row)):
            mask = op_per_row == op
            out[op] = (self.X[mask], self.y[mask])
        return out


class _Builder:
    def __init__(self) -> None:
        self.rows: List[np.ndarray] = []
        self.labels: List[float] = []
        self.group: List[int] = []
        self.keys: List[str] = []
        self.ops: List[str] = []

    def add_group(self, wl: Workload, X: np.ndarray,
                  times: Sequence[float]) -> None:
        if not len(X):
            return
        # label = log(slowdown vs the group's best): 0.0 marks the winner in
        # EVERY group, so "what a winner looks like" is one aligned level
        # across problem sizes (mean-centering left it group-dependent and
        # near-twin features across sizes got contradictory labels)
        logs = np.log(np.maximum(np.asarray(times, np.float64), 1e-12))
        logs -= logs.min()
        gid = len(self.keys)
        self.keys.append(wl.key)
        self.ops.append(wl.op)
        self.rows.extend(X)
        self.labels.extend(logs)
        self.group.extend([gid] * len(X))

    def build(self) -> Dataset:
        if not self.rows:
            return Dataset(np.empty((0, N_FEATURES)), np.empty(0),
                           np.empty(0, np.int64), [], [])
        return Dataset(np.stack(self.rows), np.asarray(self.labels),
                       np.asarray(self.group, np.int64), self.keys, self.ops)


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------

def sweep_workload(wl: Workload, objective: Optional[Objective] = None,
                   journal_dir: Optional[str] = None,
                   policy: Optional[str] = None
                   ) -> Tuple[List[Config], np.ndarray, np.ndarray]:
    """Exhaustively evaluate ``wl``'s valid space on the offline objective.

    Returns (configs, feature rows, labels). This is the dense ground
    truth: identical to what ``ExhaustiveSearch`` visits, kept as arrays
    instead of a ``TuneResult`` so every (config, label) pair becomes a
    training row rather than just the winner.  Runs on the vectorized
    sweep engine; with ``journal_dir`` the sweep checkpoints to (and
    resumes from) the per-(workload, objective) journal.

    ``policy`` makes the labels metric-aware: instead of raw seconds the
    group is labeled with that policy's scalars over the sweep's metric
    vectors (see ``repro_torch.core.policy``), so a forest can learn the
    energy/EDP ranking from the same sweeps.  The journal stays keyed by
    the raw objective — one sweep feeds every policy's dataset.  Default
    ``None`` keeps the historical time labels bit-for-bit.
    """
    objective = objective or CostModelObjective()
    wl = wl.canonical()
    space = build_space(wl)
    journal = SweepJournal.for_workload(journal_dir, wl, objective) \
        if journal_dir else None
    res = run_sweep(space, objective, journal=journal)
    cfgs = [c for c, _ in res.history]
    times = np.array([t for _, t in res.history])
    if policy is not None:
        from repro_torch.core.policy import get_policy, policy_scalar_cols
        pol = get_policy(policy, getattr(space, "spec", None))
        if pol.name != "latency" and res.metrics is not None:
            times = policy_scalar_cols(pol, res.metrics)
    X = featurize_batch(space, cfgs)
    return cfgs, X, times


def build_dataset(workloads: Iterable[Workload],
                  objective: Optional[Objective] = None,
                  on_sweep: Optional[Callable] = None,
                  journal_dir: Optional[str] = None,
                  policy: Optional[str] = None) -> Dataset:
    """Sweep every workload; one centered group per workload.

    ``on_sweep(wl, cfgs, times)`` is invoked once per workload with the
    sweep results, so callers (e.g. ``tune.py train-model --db``) can
    persist each exhaustive winner without sweeping a second time.
    ``journal_dir`` checkpoints every sweep (see ``repro_torch.tuning.sweep``),
    making a long dataset build resumable.  ``policy`` labels every group
    with that policy's scalars instead of raw seconds (see
    :func:`sweep_workload`).
    """
    objective = objective or CostModelObjective()
    b = _Builder()
    for wl in workloads:
        wl = wl.canonical()
        cfgs, X, times = sweep_workload(wl, objective,
                                        journal_dir=journal_dir,
                                        policy=policy)
        b.add_group(wl, X, times)
        if on_sweep is not None:
            on_sweep(wl, cfgs, times)
    return b.build()


def dataset_from_journal(path: str,
                         signature: Optional[str] = None,
                         policy: Optional[str] = None) -> Dataset:
    """One journal file -> one labeled group (no re-evaluation).

    ``policy`` labels the group with that policy's scalars over the
    journal's metric vectors (version-3 journals record them; pre-vector
    entries fall back to their time — see ``repro_torch.core.policy``).

    The journal header carries the workload; every completed entry whose
    config is still valid in the current space becomes a training row.
    ``signature`` (an ``Objective.signature()`` string) skips journals
    measured under a different objective — mixing, say, noisy and
    noiseless sweeps of one workload would produce conflicting labels.
    Journals from *interrupted* sweeps load too — the group is centered on
    the best time present, which is only a lower bound, but ``run_sweep``
    will finish them on the next resume.  Journals a *pruned* sweep
    started are skipped until some run completes the full space: a pruned
    subset's winner is permanently unguaranteed, and label 0.0 means
    "this IS the group optimum" (same exclusion the DB path applies to
    ``exhaustive-pruned`` records).
    """
    b = _Builder()
    journal = SweepJournal(path)
    header = journal.read_header()
    if header is None or "workload" not in header:
        return b.build()
    if signature is not None and header.get("objective") != signature:
        return b.build()
    raw_entries = journal.entries()
    if header.get("pruned") and len(raw_entries) < header.get("space_size",
                                                              float("inf")):
        return b.build()
    w = header["workload"]
    try:
        wl = Workload(op=w["op"], n=int(w["n"]), batch=int(w["batch"]),
                      dtype=w.get("dtype", "float32"),
                      variant=w.get("variant", "")).canonical()
        space = build_space(wl)
    except (KeyError, ValueError):
        return b.build()
    # featurize over the FULL valid set and select the measured rows: the
    # space-context columns (rank percentiles etc.) are defined relative to
    # every candidate in the space, and must match what sweep_workload
    # produced at training time and MLStrategy computes at predict time —
    # ranking a partial journal's subset against itself would give the same
    # config a different feature vector
    all_cfgs = space.enumerate_valid()
    index = {config_key(c): i for i, c in enumerate(all_cfgs)}
    labels = [t for _, t in raw_entries]
    if policy is not None:
        from repro_torch.core.policy import get_policy, policy_scalar_cols
        pol = get_policy(policy, getattr(space, "spec", None))
        if pol.name != "latency":
            # metric_entries dedups exactly like entries, so the vectors
            # are positionally parallel to raw_entries
            vecs = [v for _, v in journal.metric_entries()]
            axes = sorted({k for v in vecs for k in v})
            cols = {a: np.array([v.get(a, np.nan) for v in vecs])
                    for a in axes}
            labels = list(policy_scalar_cols(pol, cols))
    rows, times = [], []
    for j, (cfg, _) in enumerate(raw_entries):
        i = index.get(config_key(cfg))
        if i is not None:              # skips configs no longer enumerated
            rows.append(i)
            times.append(labels[j])
    if rows:
        b.add_group(wl, featurize_batch(space, all_cfgs)[rows], times)
    return b.build()


def dataset_from_journal_dir(journal_dir: str,
                             objective: Optional[Objective] = None,
                             policy: Optional[str] = None) -> Dataset:
    """Every ``*.jsonl`` sweep journal under ``journal_dir``, merged.

    Pass the ``objective`` the sweeps were measured with to load only its
    journals — a directory that accumulated sweeps under several
    objectives (different noise, different cost models) would otherwise
    contribute duplicate groups of one workload with inconsistent times.
    ``policy`` forwards to :func:`dataset_from_journal` (metric-aware
    labels).
    """
    import glob
    import os
    signature = objective.signature() if objective is not None else None
    parts = [dataset_from_journal(p, signature=signature, policy=policy)
             for p in sorted(glob.glob(os.path.join(journal_dir, "*.jsonl")))]
    return merge(*parts) if parts else _Builder().build()


def parse_db_key(key: str) -> Optional[Workload]:
    """Invert ``"<platform>|op:variant:nN:bB:dtype"`` back to a Workload."""
    body = key.split("|", 1)[-1]
    parts = body.split(":")
    if len(parts) != 5:
        return None
    op, variant, n_s, b_s, dtype = parts
    if not (n_s.startswith("n") and b_s.startswith("b")):
        return None
    try:
        return Workload(op=op, n=int(n_s[1:]), batch=int(b_s[1:]),
                        dtype=dtype, variant="" if variant == "default" else variant)
    except ValueError:
        return None


def dataset_from_db(db: TuningDB,
                    methods: Sequence[str] = ("exhaustive", "exhausted")
                    ) -> Dataset:
    """Turn persisted offline winners into (sparse) training rows.

    A single-row group's label is forced to 0.0 ("this is the optimum") by
    the per-group centering, so only entries stored by an exhaustive
    search — whose winner really is the group optimum — are eligible by
    default.  A ``bayesian``/``random`` winner a few ten-percent off the
    true best would otherwise teach the forest that a mediocre feature
    pattern is optimal.  Groups whose key cannot be parsed, whose op has
    no space, or whose config is no longer valid are skipped.
    """
    allowed = set(methods)
    b = _Builder()
    for key, entry in sorted(db.entries().items()):
        wl = parse_db_key(key)
        if wl is None or "config" not in entry:
            continue
        if entry.get("method") not in allowed:
            continue
        try:
            space = build_space(wl.canonical())
            cfg = dict(entry["config"])
            if not space.is_valid(cfg):
                continue
            # context features need the full candidate set; keep cfg's row
            cfgs = space.enumerate_valid()
            i = cfgs.index(cfg)
            X = featurize_batch(space, cfgs)[i: i + 1]
        except (KeyError, ValueError, TypeError):
            # unknown op, config no longer enumerated, or a malformed
            # record (e.g. an unparseable dtype): skip, don't abort training
            continue
        b.add_group(wl.canonical(), X, [float(entry.get("time_s", 1.0))])
    return b.build()


def merge(*datasets: Dataset) -> Dataset:
    """Concatenate datasets, re-basing group ids."""
    parts = [d for d in datasets if len(d)]
    if not parts:
        return Dataset(np.empty((0, N_FEATURES)), np.empty(0),
                       np.empty(0, np.int64), [], [])
    keys: List[str] = []
    ops: List[str] = []
    groups = []
    for d in parts:
        groups.append(d.group + len(keys))
        keys.extend(d.keys)
        ops.extend(d.ops)
    return Dataset(np.concatenate([d.X for d in parts]),
                   np.concatenate([d.y for d in parts]),
                   np.concatenate(groups), keys, ops)


def split_by_size(workloads: Iterable[Workload],
                  holdout_sizes: Dict[str, Sequence[int]]
                  ) -> Tuple[List[Workload], List[Workload]]:
    """Partition workloads into (train, holdout) by per-op problem size."""
    train, hold = [], []
    for wl in workloads:
        if wl.n in set(holdout_sizes.get(wl.op, ())):
            hold.append(wl)
        else:
            train.append(wl)
    return train, hold
