"""Exhaustive and random searches (the paper's ground truth + sanity baseline)."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.bayesian import TuneResult
from repro_torch.core.objective import Objective, PENALTY_TIME
from repro_torch.core.space import Config, SearchSpace


class ExhaustiveSearch:
    """Evaluates every valid configuration. Guarantees the optimum; used to
    compute the paper's Phi metric denominators.

    Runs on the ``repro_torch.tuning.sweep`` engine: candidates are evaluated in
    vectorized batches through ``Objective.batch_eval``; with
    ``journal_dir`` each chunk checkpoints to a per-(workload, objective)
    JSONL journal so interrupted sweeps resume instead of restarting.
    """

    name = "exhaustive"

    def __init__(self, journal_dir: Optional[str] = None):
        self.journal_dir = journal_dir

    def tune(self, space: SearchSpace, objective: Objective) -> TuneResult:
        # deferred import: repro_torch.tuning.session imports this module
        from repro_torch.tuning.sweep import SweepJournal, run_sweep

        journal = None
        if self.journal_dir:
            journal = SweepJournal.for_workload(self.journal_dir,
                                                space.workload, objective)
        result = run_sweep(space, objective, journal=journal)
        return result.as_tune_result()


class RandomSearch:
    """Uniform random sampling without replacement — the bar any smarter
    search must beat (cf. the paper's citation of [35])."""

    name = "random"

    def __init__(self, max_evals: int = 16, seed: int = 0):
        self.max_evals = max_evals
        self.seed = seed

    def tune(self, space: SearchSpace, objective: Objective) -> TuneResult:
        rng = np.random.default_rng(self.seed)
        candidates = space.enumerate_valid()
        if not candidates:
            raise ValueError(f"empty search space for {space.workload.key}")
        order = rng.permutation(len(candidates))[: self.max_evals]
        history: List[Tuple[Config, float]] = []
        best_cfg, best_t = None, float("inf")
        for idx in order:
            cfg = candidates[int(idx)]
            m = objective(space, cfg)
            t = m.time_s if m.valid else PENALTY_TIME
            history.append((cfg, t))
            if t < best_t:
                best_cfg, best_t = cfg, t
        # same semantics as BayesianTuner: "max_evals" only when the budget
        # was the binding constraint; a full enumeration is "exhausted"
        stopped_by = "max_evals" if len(history) >= self.max_evals \
            else "exhausted"
        return TuneResult(best_cfg, best_t, len(history), history, stopped_by)
