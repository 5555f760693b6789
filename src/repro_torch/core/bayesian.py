"""ML-based tuning via Bayesian optimization (paper §IV-B).

Workflow (identical to the paper's GPTune-driven loop):
  1. bootstrap: randomly sample `n_init` configurations, evaluate them;
  2. fit the surrogate model on (encoded config -> log time);
  3. maximize the Expected Improvement acquisition over the *remaining*
     valid configs (spaces are enumerable, so acquisition optimization is
     exact — the paper's spaces are likewise small/discrete);
  4. evaluate the winner, append to the dataset, repeat;
  5. stop on the sliding-window criterion: no improvement within the last
     `patience` evaluations (paper: 5), or when the space is exhausted, or
     at `max_evals`.

Surrogate: a Gaussian process with an RBF kernel over the log2-normalized
parameter encoding ("LCM-lite" — GPTune's Linear Coregionalization Model
reduces to a single-task GP when tuning one task at a time, which is how the
paper uses it per (algorithm, N)). Pure numpy; no external deps.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.objective import Objective, PENALTY_TIME
from repro_torch.core.space import Config, SearchSpace


@dataclasses.dataclass
class GP:
    """RBF-kernel Gaussian process regression (zero mean on standardized y)."""

    lengthscale: float = 0.35
    signal: float = 1.0
    noise: float = 1e-4

    x: Optional[np.ndarray] = None
    y_mean: float = 0.0
    y_std: float = 1.0
    alpha: Optional[np.ndarray] = None
    chol: Optional[np.ndarray] = None

    def _k(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.signal * np.exp(-0.5 * d2 / self.lengthscale**2)

    def fit(self, x: np.ndarray, y: np.ndarray) -> "GP":
        self.x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self.y_mean = float(y.mean())
        self.y_std = float(y.std()) or 1.0
        yn = (y - self.y_mean) / self.y_std
        k = self._k(self.x, self.x) + self.noise * np.eye(len(y))
        self.chol = np.linalg.cholesky(k)
        self.alpha = np.linalg.solve(self.chol.T, np.linalg.solve(self.chol, yn))
        return self

    def predict(self, xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        xq = np.asarray(xq, dtype=np.float64)
        ks = self._k(xq, self.x)
        mu = ks @ self.alpha
        v = np.linalg.solve(self.chol, ks.T)
        var = np.clip(self.signal - (v**2).sum(0), 1e-12, None)
        return mu * self.y_std + self.y_mean, np.sqrt(var) * self.y_std


# elementwise math.erf: exact to double precision and keeps this module's
# "pure numpy; no external deps" contract (scipy is only a transitive
# extra of jax and absent from requirements-ci.txt)
_erf = np.vectorize(math.erf, otypes=[np.float64])


def expected_improvement(mu: np.ndarray, sigma: np.ndarray, best: float) -> np.ndarray:
    """EI for minimization (Mockus 1975, the paper's acquisition)."""
    sigma = np.maximum(sigma, 1e-12)
    z = (best - mu) / sigma
    phi = np.exp(-0.5 * z**2) / math.sqrt(2 * math.pi)
    cdf = 0.5 * (1.0 + _erf(z / math.sqrt(2)))
    return (best - mu) * cdf + sigma * phi


@dataclasses.dataclass
class TuneResult:
    best_config: Config
    best_time: float
    evaluations: int          # unique objective evaluations (paper Fig 4)
    history: List[Tuple[Config, float]]
    stopped_by: str


class BayesianTuner:
    name = "bayesian"

    def __init__(self, n_init: Optional[int] = None, patience: int = 5,
                 max_evals: int = 64, seed: int = 0, xi: float = 0.01):
        self.n_init = n_init           # None -> adaptive to |space|
        self.patience = patience       # paper: stop if no progress in last 5
        self.max_evals = max_evals
        self.seed = seed
        self.xi = xi                   # exploration bonus on `best`

    def tune(self, space: SearchSpace, objective: Objective) -> TuneResult:
        rng = np.random.default_rng(self.seed)
        candidates = space.enumerate_valid()
        if not candidates:
            raise ValueError(f"empty search space for {space.workload.key}")
        enc = np.array([space.encode(c) for c in candidates], dtype=np.float64)

        order = rng.permutation(len(candidates))
        history: List[Tuple[Config, float]] = []
        evaluated: Dict[int, float] = {}

        def measure(idx: int) -> float:
            m = objective(space, candidates[idx])
            t = m.time_s if m.valid else PENALTY_TIME
            evaluated[idx] = t
            history.append((candidates[idx], t))
            return t

        # --- bootstrap (adaptive: bigger spaces warrant a broader prior,
        # matching the paper's higher evaluation counts on large spaces) ---
        n_init = self.n_init if self.n_init is not None else min(
            max(4, len(candidates) // 24), 12)
        for idx in order[: min(n_init, len(candidates))]:
            measure(int(idx))

        best_idx = min(evaluated, key=evaluated.get)
        best_t = evaluated[best_idx]
        since_improve = 0
        stopped_by = "exhausted"

        while len(evaluated) < min(self.max_evals, len(candidates)):
            if since_improve >= self.patience:
                stopped_by = "sliding_window"
                break
            xs = enc[list(evaluated.keys())]
            ys = np.log(np.array(list(evaluated.values())))
            gp = GP().fit(xs, ys)
            remaining = [i for i in range(len(candidates)) if i not in evaluated]
            mu, sigma = gp.predict(enc[remaining])
            ei = expected_improvement(mu, sigma, math.log(best_t) - self.xi)
            pick = remaining[int(np.argmax(ei))]
            t = measure(pick)
            if t < best_t * (1 - 1e-9):
                best_t, best_idx = t, pick
                since_improve = 0
            else:
                since_improve += 1
        else:
            stopped_by = "max_evals" if len(evaluated) >= self.max_evals else "exhausted"

        return TuneResult(
            best_config=candidates[best_idx],
            best_time=best_t,
            evaluations=len(evaluated),
            history=history,
            stopped_by=stopped_by,
        )
