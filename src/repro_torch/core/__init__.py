"""repro_torch.core — the paper's contribution: tuning methodologies.

Public API:
  Workload, build_space      — declare what to tune (paper Table I)
  AnalyticalTuner            — model-driven, zero-evaluation (paper IV-A)
  BayesianTuner              — BO with GP surrogate + EI (paper IV-B)
  ExhaustiveSearch, RandomSearch
  TransferBayesianTuner      — BO warm-started across sizes and devices
  Policy, PolicyObjective    — what "better" means (latency / energy / edp /
                               memory_cap)
  phi, efficiency            — portability metric (paper VI)
"""
from repro_torch.core.analytical import AnalyticalTuner
from repro_torch.core.bayesian import BayesianTuner, TuneResult
from repro_torch.core.exhaustive import ExhaustiveSearch, RandomSearch
from repro_torch.core.metrics import efficiency, phi, phi_from_times
from repro_torch.core.objective import (CachedObjective, CostModelObjective,
                                        Measurement, Objective, PENALTY_TIME,
                                        RunnerError, WallClockObjective)
from repro_torch.core.policy import Policy, PolicyObjective, get_policy
from repro_torch.core.space import (Config, ParamSpec, SearchSpace, Workload,
                                    build_space)
from repro_torch.core.transfer import TransferBayesianTuner

__all__ = [
    "AnalyticalTuner", "BayesianTuner", "TuneResult", "ExhaustiveSearch",
    "RandomSearch", "efficiency", "phi", "phi_from_times", "CachedObjective",
    "Measurement", "Objective", "PENALTY_TIME", "CostModelObjective",
    "RunnerError", "WallClockObjective", "Config", "ParamSpec", "SearchSpace",
    "Workload", "build_space", "Policy", "PolicyObjective", "get_policy",
    "TransferBayesianTuner",
]
